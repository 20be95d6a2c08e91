"""qr_rr_s: the dense linear algebra's seconds per solve — the port's
``PerfData`` phases "Qr" plus "Rr" (traced run only), the mean over the
window's solves."""


def read(run):
    t = [s.timings["Qr"] + s.timings["Rr"] for s in run.solves
         if s.timings is not None]
    return sum(t) / len(t) if t else None

"""peak_mem_gib: the device memory a solve needs, in GiB — the bytes
handed to it (H, and a warm start's block) plus the most it allocated
above what was allocated when it was called (``torch.cuda``'s allocator,
reset before each solve), the largest over the window's solves.  The
outputs the benchmark keeps for the reference are not counted."""


def read(run):
    peaks = [s.input_bytes + s.mem_added for s in run.solves
             if s.mem_added is not None and s.error is None]
    return max(peaks) / 2**30 if peaks else None

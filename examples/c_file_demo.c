/* C driver that solves a Clement matrix stored in a ChASE binary file
 * through the reference-named C ABI, in single precision — the
 * reference's examples/2_input_output pattern from C.  It links against
 * either library: libchase_tpu_torch.so (the PyTorch/CUDA port) or
 * libchase_tpu.so (the JAX package).
 *
 *   schase_init_internal_ (no H buffer: H = NULL) + schase_readHam_ (the
 *   file) + chase_set_tol_ + schase_ + schase_get_eigenpairs_ +
 *   schase_finalize_, each timed;
 *   the eigenvalues checked against Clement's exact spectrum
 *   -(N-1) + 2i, and the true residual ||H v - lambda v|| of every
 *   returned pair computed here from Clement's tridiagonal structure
 *   (O(N) per column, in double); the gates are an eigenvalue error of
 *   at most 0.5 and a true residual of at most 10*TOL for every pair.
 *
 * Usage: c_file_demo FILE N NEV NEX TOL
 *   FILE holds the N x N float32 Clement matrix, column-major (e.g.
 *   chase_tpu_torch.io.save_matrix(clement(N, np.float32), FILE)).
 *
 * Build and run against the port:
 *   python -c "from chase_tpu_torch._native import build_capi; print(build_capi())"
 *   cc examples/c_file_demo.c -L<dir> -lchase_tpu_torch -lm \
 *      -Wl,-rpath,<dir> -o c_file_demo
 *   PYTHONPATH=$PWD ./c_file_demo H.bin 1000 100 40 1e-4
 * It prints its times, then "c_file_demo: PASS" or "... FAIL" (exit 1).
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

void schase_init_internal_(int*, int*, int*, float*, int*, int*);
void schase_readHam_(const char*);
void schase_(int*, float*, char*, char*, char*);
void schase_get_eigenpairs_(float*, int*, float*);
void schase_finalize_(int*);
void chase_set_tol_(double*);
void chase_print_config_(void);

static double now(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

int main(int argc, char** argv) {
    if (argc != 6) {
        fprintf(stderr, "usage: %s FILE N NEV NEX TOL\n", argv[0]);
        return 2;
    }
    const char* path = argv[1];
    int N = atoi(argv[2]), nev = atoi(argv[3]), nex = atoi(argv[4]);
    double tol = atof(argv[5]);
    const double ev_gate = 0.5, res_gate = 10.0 * tol;
    int ldh = N, init = 0, flag = 0, deg = 0;   /* deg 0: the default */
    float ftol = (float)tol;
    char mode = 'R', opt = 'S', qr = 'C';
    float* V = (float*)malloc((size_t)N * nev * sizeof(float));
    float* ritzv = (float*)malloc((size_t)nev * sizeof(float));
    if (!V || !ritzv) {
        fprintf(stderr, "c_file_demo: out of memory\n");
        return 2;
    }

    double t0 = now();
    schase_init_internal_(&N, &nev, &nex, NULL, &ldh, &init);
    double t1 = now();
    schase_readHam_(path);
    double t2 = now();
    chase_set_tol_(&tol);
    schase_(&deg, &ftol, &mode, &opt, &qr);
    double t3 = now();
    schase_get_eigenpairs_(V, &N, ritzv);
    double t4 = now();
    chase_print_config_();
    schase_finalize_(&flag);
    fflush(stdout);

    /* Clement: H(i, i+1) = H(i+1, i) = sqrt((i+1)(N-1-i)), zero diagonal */
    double ev_err = 0, res_max = 0;
    for (int j = 0; j < nev; ++j) {
        double want = -(double)(N - 1) + 2.0 * j;
        double e = fabs((double)ritzv[j] - want);
        if (e > ev_err) ev_err = e;
        const float* v = V + (size_t)j * N;
        double r2 = 0;
        for (int i = 0; i < N; ++i) {
            double hv = 0;
            if (i > 0) hv += sqrt((double)i * (N - i)) * v[i - 1];
            if (i < N - 1) hv += sqrt((double)(i + 1) * (N - 1 - i)) * v[i + 1];
            double d = hv - (double)ritzv[j] * v[i];
            r2 += d * d;
        }
        if (sqrt(r2) > res_max) res_max = sqrt(r2);
    }
    printf("c_file_demo: N=%d nev=%d nex=%d tol=%g: init %.3f s, readHam "
           "%.3f s, solve %.3f s, get %.3f s\n", N, nev, nex, tol, t1 - t0,
           t2 - t1, t3 - t2, t4 - t3);
    printf("c_file_demo: lambda[0] = %.6f, lambda[%d] = %.6f; max "
           "eigenvalue error %.3e (gate %g), max true residual %.3e "
           "(gate %g)\n", ritzv[0], nev - 1, ritzv[nev - 1], ev_err, ev_gate,
           res_max, res_gate);
    int ok = ev_err <= ev_gate && res_max <= res_gate;
    printf(ok ? "c_file_demo: PASS\n" : "c_file_demo: FAIL\n");
    free(V);
    free(ritzv);
    return ok ? 0 : 1;
}

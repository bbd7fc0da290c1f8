/* Boys function F_m(T) for m = 0..mmax, batched over T.
 *
 * Native analog of the reference's compiled integral kernels
 * (_cpp/eri_sparse_DF.cpp is its only C++ extension); here the host-side
 * hot spot of the from-scratch McMurchie-Davidson engine.
 *
 * Small T (T < mmax + 5): convergent series at F_mmax (all-positive
 * terms, no cancellation), then the stable downward recursion.
 * Large T (T >= mmax + 5): F_0 = sqrt(pi/T)/2 * erf(sqrt(T)) from libm,
 * then the upward recursion F_{m+1} = ((2m+1) F_m - e^{-T}) / (2T),
 * which is stable only when 2T stays above 2m+1 for every m < mmax —
 * guaranteed by the branch condition since 2T >= 2 mmax + 10.
 */

#include <math.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C"
#endif
void boys_batch(int mmax, const double *T, ptrdiff_t n, double *out)
{
    const double SMALL = 1e-13;
    for (ptrdiff_t i = 0; i < n; ++i) {
        double t = T[i];
        double *col = out + i;            /* out[m*n + i] */
        if (t < SMALL) {
            for (int m = 0; m <= mmax; ++m)
                col[(ptrdiff_t)m * n] =
                    1.0 / (2.0 * m + 1.0) - t / (2.0 * m + 3.0);
            continue;
        }
        double expt = exp(-t);
        if (t < mmax + 5.0) {
            double denom = 2.0 * mmax + 1.0;
            double term = 1.0 / denom;
            double sum = term;
            for (int k = 1; k < 400; ++k) {
                denom += 2.0;
                term *= 2.0 * t / denom;
                sum += term;
                if (term < 1e-17 * sum) break;
            }
            double fm = expt * sum;
            col[(ptrdiff_t)mmax * n] = fm;
            for (int m = mmax; m > 0; --m) {
                fm = (2.0 * t * fm + expt) / (2.0 * m - 1.0);
                col[(ptrdiff_t)(m - 1) * n] = fm;
            }
        } else {
            double f = 0.5 * sqrt(M_PI / t) * erf(sqrt(t));
            col[0] = f;
            double inv2t = 0.5 / t;
            for (int m = 0; m < mmax; ++m) {
                f = ((2.0 * m + 1.0) * f - expt) * inv2t;
                col[(ptrdiff_t)(m + 1) * n] = f;
            }
        }
    }
}

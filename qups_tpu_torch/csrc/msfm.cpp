// Fast-marching eikonal solver (2-D / 3-D), first + second order upwind.
//
// The port's copy of the JAX package's host solver (qups_tpu/native/
// msfm.cpp), the same source line for line below this header: one-way
// travel-time maps T(x) solving |grad T| = 1/F(x) from point sources, the
// capability of QUPS's multistencil fast-marching MEX solver
// (src/FMM/functions/msfm2d.c, msfm3d.c, common.c), used by the eikonal
// beamformer for heterogeneous sound-speed delay tables
// (UltrasoundSystem.bfEikonal). Sethian's FMM with a binary min-heap
// frontier and optional second-order differences; a sequential frontier
// algorithm, so it runs on the host CPU (one map per element, in parallel
// over elements by the caller's threads).
//
// Build: qups_tpu_torch/ops/_nvcc.py::load_host compiles it at first use
// with the host C++ compiler and the JAX package's Makefile flags
// (-O3 -fPIC -std=c++17 -Wall -shared) into qups_tpu_torch/_build/, and
// qups_tpu_torch/ops/eikonal.py loads it with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr double KINF = 1e38;

struct Heap {
    // binary min-heap of (value, index) with back-pointers for decrease-key
    std::vector<double> val;
    std::vector<int64_t> idx;     // heap position -> grid index
    std::vector<int64_t> pos;     // grid index -> heap position (-1 absent)

    explicit Heap(int64_t n) : pos(n, -1) {}

    bool empty() const { return val.empty(); }

    void swap_nodes(int64_t a, int64_t b) {
        std::swap(val[a], val[b]);
        std::swap(idx[a], idx[b]);
        pos[idx[a]] = a;
        pos[idx[b]] = b;
    }

    void up(int64_t i) {
        while (i > 0) {
            int64_t p = (i - 1) / 2;
            if (val[p] <= val[i]) break;
            swap_nodes(p, i);
            i = p;
        }
    }

    void down(int64_t i) {
        int64_t n = (int64_t)val.size();
        for (;;) {
            int64_t l = 2 * i + 1, r = 2 * i + 2, m = i;
            if (l < n && val[l] < val[m]) m = l;
            if (r < n && val[r] < val[m]) m = r;
            if (m == i) break;
            swap_nodes(m, i);
            i = m;
        }
    }

    void push_or_update(int64_t gi, double v) {
        int64_t p = pos[gi];
        if (p < 0) {
            val.push_back(v);
            idx.push_back(gi);
            p = (int64_t)val.size() - 1;
            pos[gi] = p;
            up(p);
        } else if (v < val[p]) {
            val[p] = v;
            up(p);
        }
    }

    int64_t pop() {
        int64_t gi = idx[0];
        int64_t n = (int64_t)val.size() - 1;
        if (n > 0) swap_nodes(0, n);
        val.pop_back();
        idx.pop_back();
        pos[gi] = -2;  // frozen (set after the swap, which rewrites pos)
        if (n > 0) down(0);
        return gi;
    }
};

// Solve the quadratic upwind update: sum_d ((T - a_d) / h_d)^2 = s^2 over
// the dims with a valid upwind value a_d. Returns the root > max(a_d).
inline double solve_update(const double* a, const double* w, int nd, double s2) {
    // sum_d w_d (T - a_d)^2 = s2 ; w_d = 1/h_d^2 (already includes 2nd-order
    // coefficient scaling)
    double A = 0, B = 0, C = -s2;
    for (int d = 0; d < nd; ++d) {
        A += w[d];
        B -= 2.0 * w[d] * a[d];
        C += w[d] * a[d] * a[d];
    }
    double disc = B * B - 4 * A * C;
    if (disc < 0) {
        // fall back to the smallest 1-D update
        double best = KINF;
        for (int d = 0; d < nd; ++d) {
            double t = a[d] + std::sqrt(s2 / w[d]);
            best = std::min(best, t);
        }
        return best;
    }
    return (-B + std::sqrt(disc)) / (2 * A);
}

}  // namespace

extern "C" {

// 2-D fast marching.
//  F      : speed map (n0 x n1), row-major (index = i0 * n1 + i1) [m/s]
//  n0, n1 : grid sizes; h: isotropic grid spacing [m]
//  src    : ns source cells as (i0, i1) int64 pairs
//  order2 : use second-order upwind differences where available
//  T      : output travel time [s]
// t0-aware variant: per-source initial times seed WAVEFRONT sources
// (virtual-source / boundary-seeded transmits; t0 == nullptr -> all zero)
void msfm2d_t0(const double* F, int64_t n0, int64_t n1, double h,
               const int64_t* src, const double* t0, int64_t ns, int order2,
               double* T) {
    const int64_t n = n0 * n1;
    std::fill(T, T + n, KINF);
    Heap heap(n);

    // analytic initialization in a small disk around each source removes
    // the FMM source singularity (local speed assumed constant there)
    const int64_t R = 3;
    for (int64_t s = 0; s < ns; ++s) {
        int64_t i0 = src[2 * s], i1 = src[2 * s + 1];
        double f0 = F[i0 * n1 + i1];
        if (!(f0 > 0)) f0 = 1.0;
        double ts = t0 ? t0[s] : 0.0;
        for (int64_t a = -R; a <= R; ++a) {
            for (int64_t b = -R; b <= R; ++b) {
                int64_t j0 = i0 + a, j1 = i1 + b;
                if (j0 < 0 || j0 >= n0 || j1 < 0 || j1 >= n1) continue;
                double r = h * std::sqrt(double(a * a + b * b));
                if (r > R * h) continue;
                int64_t gj = j0 * n1 + j1;
                double t = ts + r / f0;
                if (t < T[gj]) {
                    T[gj] = t;
                    heap.push_or_update(gj, t);
                }
            }
        }
    }

    auto frozen = [&](int64_t gi) { return heap.pos[gi] == -2; };

    const int64_t d0[4] = {-1, 1, 0, 0};
    const int64_t d1[4] = {0, 0, -1, 1};

    while (!heap.empty()) {
        int64_t gi = heap.pop();
        int64_t i0 = gi / n1, i1 = gi % n1;
        // relax the 4-neighbors
        for (int k = 0; k < 4; ++k) {
            int64_t j0 = i0 + d0[k], j1 = i1 + d1[k];
            if (j0 < 0 || j0 >= n0 || j1 < 0 || j1 >= n1) continue;
            int64_t gj = j0 * n1 + j1;
            if (frozen(gj)) continue;
            double f = F[gj];
            if (!(f > 0)) continue;
            double s2 = 1.0 / (f * f);
            // upwind values per axis (first or second order)
            double a[2], w[2];
            int nd = 0;
            const double invh2 = 1.0 / (h * h);
            // axis 0
            {
                double t1 = KINF, t2 = KINF;
                bool o2 = false;
                if (j0 - 1 >= 0 && frozen(gj - n1)) {
                    t1 = T[gj - n1];
                    if (order2 && j0 - 2 >= 0 && frozen(gj - 2 * n1) &&
                        T[gj - 2 * n1] <= t1) { t2 = T[gj - 2 * n1]; o2 = true; }
                }
                if (j0 + 1 < n0 && frozen(gj + n1) && T[gj + n1] < t1) {
                    t1 = T[gj + n1];
                    o2 = false;
                    if (order2 && j0 + 2 < n0 && frozen(gj + 2 * n1) &&
                        T[gj + 2 * n1] <= t1) { t2 = T[gj + 2 * n1]; o2 = true; }
                }
                if (t1 < KINF) {
                    if (o2) { a[nd] = (4 * t1 - t2) / 3.0; w[nd] = 2.25 * invh2; }
                    else { a[nd] = t1; w[nd] = invh2; }
                    ++nd;
                }
            }
            // axis 1
            {
                double t1 = KINF, t2 = KINF;
                bool o2 = false;
                if (j1 - 1 >= 0 && frozen(gj - 1)) {
                    t1 = T[gj - 1];
                    if (order2 && j1 - 2 >= 0 && frozen(gj - 2) &&
                        T[gj - 2] <= t1) { t2 = T[gj - 2]; o2 = true; }
                }
                if (j1 + 1 < n1 && frozen(gj + 1) && T[gj + 1] < t1) {
                    t1 = T[gj + 1];
                    o2 = false;
                    if (order2 && j1 + 2 < n1 && frozen(gj + 2) &&
                        T[gj + 2] <= t1) { t2 = T[gj + 2]; o2 = true; }
                }
                if (t1 < KINF) {
                    if (o2) { a[nd] = (4 * t1 - t2) / 3.0; w[nd] = 2.25 * invh2; }
                    else { a[nd] = t1; w[nd] = invh2; }
                    ++nd;
                }
            }
            if (nd == 0) continue;
            double tn = solve_update(a, w, nd, s2);
            if (tn < T[gj]) {
                T[gj] = tn;
                heap.push_or_update(gj, tn);
            }
        }
    }
}

// 3-D fast marching; F is (n0 x n1 x n2) row-major.
void msfm3d_t0(const double* F, int64_t n0, int64_t n1, int64_t n2,
               double h, const int64_t* src, const double* t0, int64_t ns,
               int order2, double* T) {
    const int64_t n = n0 * n1 * n2;
    const int64_t s0 = n1 * n2, s1 = n2, s2s = 1;
    std::fill(T, T + n, KINF);
    Heap heap(n);
    const int64_t R = 3;
    for (int64_t s = 0; s < ns; ++s) {
        int64_t i0 = src[3 * s], i1 = src[3 * s + 1], i2 = src[3 * s + 2];
        double f0 = F[i0 * s0 + i1 * s1 + i2];
        if (!(f0 > 0)) f0 = 1.0;
        double ts = t0 ? t0[s] : 0.0;
        for (int64_t a = -R; a <= R; ++a)
        for (int64_t b = -R; b <= R; ++b)
        for (int64_t c = -R; c <= R; ++c) {
            int64_t j0 = i0 + a, j1 = i1 + b, j2 = i2 + c;
            if (j0 < 0 || j0 >= n0 || j1 < 0 || j1 >= n1 ||
                j2 < 0 || j2 >= n2) continue;
            double r = h * std::sqrt(double(a * a + b * b + c * c));
            if (r > R * h) continue;
            int64_t gj = j0 * s0 + j1 * s1 + j2;
            double t = ts + r / f0;
            if (t < T[gj]) {
                T[gj] = t;
                heap.push_or_update(gj, t);
            }
        }
    }
    auto frozen = [&](int64_t gi) { return heap.pos[gi] == -2; };
    const int64_t strides[3] = {s0, s1, s2s};
    const int64_t sizes[3] = {n0, n1, n2};
    const double invh2 = 1.0 / (h * h);

    while (!heap.empty()) {
        int64_t gi = heap.pop();
        int64_t c[3];
        c[0] = gi / s0;
        c[1] = (gi / s1) % n1;
        c[2] = gi % n2;
        for (int ax = 0; ax < 3; ++ax) {
            for (int dir = -1; dir <= 1; dir += 2) {
                int64_t jc[3] = {c[0], c[1], c[2]};
                jc[ax] += dir;
                if (jc[ax] < 0 || jc[ax] >= sizes[ax]) continue;
                int64_t gj = jc[0] * s0 + jc[1] * s1 + jc[2];
                if (frozen(gj)) continue;
                double f = F[gj];
                if (!(f > 0)) continue;
                double rhs = 1.0 / (f * f);
                double a[3], w[3];
                int nd = 0;
                for (int d = 0; d < 3; ++d) {
                    double t1 = KINF, t2 = KINF;
                    bool o2 = false;
                    if (jc[d] - 1 >= 0 && frozen(gj - strides[d])) {
                        t1 = T[gj - strides[d]];
                        if (order2 && jc[d] - 2 >= 0 && frozen(gj - 2 * strides[d])
                            && T[gj - 2 * strides[d]] <= t1) {
                            t2 = T[gj - 2 * strides[d]]; o2 = true;
                        }
                    }
                    if (jc[d] + 1 < sizes[d] && frozen(gj + strides[d])
                        && T[gj + strides[d]] < t1) {
                        t1 = T[gj + strides[d]];
                        o2 = false;
                        if (order2 && jc[d] + 2 < sizes[d]
                            && frozen(gj + 2 * strides[d])
                            && T[gj + 2 * strides[d]] <= t1) {
                            t2 = T[gj + 2 * strides[d]]; o2 = true;
                        }
                    }
                    if (t1 < KINF) {
                        if (o2) { a[nd] = (4 * t1 - t2) / 3.0; w[nd] = 2.25 * invh2; }
                        else { a[nd] = t1; w[nd] = invh2; }
                        ++nd;
                    }
                }
                if (nd == 0) continue;
                double tn = solve_update(a, w, nd, rhs);
                if (tn < T[gj]) {
                    T[gj] = tn;
                    heap.push_or_update(gj, tn);
                }
            }
        }
    }
}


// original point-source entry points (t0 = 0 for every source)
void msfm2d(const double* F, int64_t n0, int64_t n1, double h,
            const int64_t* src, int64_t ns, int order2, double* T) {
    msfm2d_t0(F, n0, n1, h, src, nullptr, ns, order2, T);
}

void msfm3d(const double* F, int64_t n0, int64_t n1, int64_t n2, double h,
            const int64_t* src, int64_t ns, int order2, double* T) {
    msfm3d_t0(F, n0, n1, n2, h, src, nullptr, ns, order2, T);
}

}  // extern "C"

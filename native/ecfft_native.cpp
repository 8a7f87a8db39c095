// ecfft-tpu native runtime: single-core C++ ECFFT engine.
//
// Role in the framework (SURVEY.md §2: the reference is a Rust/arkworks
// crate; our compute path is JAX/XLA on the GPU, and this module is the
// native host runtime around it):
//   1. independent correctness oracle for the device path at sizes the
//      pure-python oracle can't reach,
//   2. the measured "single-core Montgomery-backend" baseline that
//      bench.py's vs_baseline compares against (arkworks-class 4x64
//      Montgomery multiplication via __uint128_t),
//   3. fast host-side FFTree construction for large n (the O(n log^3 n)
//      bootstrap) feeding precomputed tables to the device,
//   4. ark-serialize-compatible byte emission for interop checks.
//
// Architecture mirrors the *device* design, not the reference's: per-size
// flat tables (no boxed subtree chain) and iterative butterfly loops
// (see ecfft_tpu/ops/core.py). Semantics match /root/reference/src/
// fftree.rs:72-316 (cited per function).
//
// Field elements cross the C boundary as 32-byte little-endian canonical
// integers; internally everything is 4x64-limb Montgomery form with
// R = 2^256 (matching arkworks' Fp256<MontBackend<_,4>>, lib.rs:37).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <string>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

namespace {

constexpr int NL = 4;  // 4 x 64-bit limbs

struct Fe {
  u64 v[NL];
};

struct FieldCtx {
  Fe p;        // modulus
  Fe r2;       // R^2 mod p
  Fe one_m;    // R mod p (montgomery 1)
  u64 inv;     // -p^{-1} mod 2^64
  Fe p_minus_2;  // exponent for fermat inversion
};

static inline bool fe_eq(const Fe &a, const Fe &b) {
  return std::memcmp(a.v, b.v, sizeof(Fe)) == 0;
}

static inline bool fe_is_zero(const Fe &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline int fe_cmp(const Fe &a, const Fe &b) {
  for (int i = NL - 1; i >= 0; --i) {
    if (a.v[i] < b.v[i]) return -1;
    if (a.v[i] > b.v[i]) return 1;
  }
  return 0;
}

static inline void fe_sub_raw(Fe &out, const Fe &a, const Fe &b) {
  u128 borrow = 0;
  for (int i = 0; i < NL; ++i) {
    u128 t = (u128)a.v[i] - b.v[i] - borrow;
    out.v[i] = (u64)t;
    borrow = (t >> 64) & 1;
  }
}

static inline u64 fe_add_raw(Fe &out, const Fe &a, const Fe &b) {
  u128 carry = 0;
  for (int i = 0; i < NL; ++i) {
    u128 t = (u128)a.v[i] + b.v[i] + carry;
    out.v[i] = (u64)t;
    carry = t >> 64;
  }
  return (u64)carry;
}

static inline void fe_add(const FieldCtx &F, Fe &out, const Fe &a, const Fe &b) {
  u64 carry = fe_add_raw(out, a, b);
  if (carry || fe_cmp(out, F.p) >= 0) {
    Fe t;
    fe_sub_raw(t, out, F.p);
    out = t;
  }
}

static inline void fe_sub(const FieldCtx &F, Fe &out, const Fe &a, const Fe &b) {
  if (fe_cmp(a, b) >= 0) {
    fe_sub_raw(out, a, b);
  } else {
    Fe t;
    fe_add_raw(t, a, F.p);
    fe_sub_raw(out, t, b);
  }
}

static inline void fe_neg(const FieldCtx &F, Fe &out, const Fe &a) {
  if (fe_is_zero(a)) { out = a; return; }
  fe_sub_raw(out, F.p, a);
}

// CIOS Montgomery multiplication: out = a*b*R^-1 mod p.
static inline void fe_mul(const FieldCtx &F, Fe &out, const Fe &a, const Fe &b) {
  u64 t[NL + 2] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < NL; ++i) {
    // t += a[i] * b
    u128 carry = 0;
    for (int j = 0; j < NL; ++j) {
      u128 cur = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[NL] + carry;
    t[NL] = (u64)cur;
    t[NL + 1] = (u64)(cur >> 64);
    // montgomery step
    u64 m = t[0] * F.inv;
    carry = ((u128)t[0] + (u128)m * F.p.v[0]) >> 64;
    for (int j = 1; j < NL; ++j) {
      u128 c2 = (u128)t[j] + (u128)m * F.p.v[j] + carry;
      t[j - 1] = (u64)c2;
      carry = c2 >> 64;
    }
    cur = (u128)t[NL] + carry;
    t[NL - 1] = (u64)cur;
    t[NL] = t[NL + 1] + (u64)(cur >> 64);
    t[NL + 1] = 0;
  }
  Fe r;
  std::memcpy(r.v, t, sizeof(Fe));
  if (t[NL] || fe_cmp(r, F.p) >= 0) {
    Fe s;
    fe_sub_raw(s, r, F.p);
    r = s;
  }
  out = r;
}

static inline void fe_sqr(const FieldCtx &F, Fe &out, const Fe &a) {
  fe_mul(F, out, a, a);
}

static void fe_pow(const FieldCtx &F, Fe &out, const Fe &base, const Fe &exp) {
  Fe acc = base;
  Fe res = F.one_m;
  for (int i = 0; i < NL; ++i) {
    u64 e = exp.v[i];
    for (int b = 0; b < 64; ++b) {
      if (e & 1) fe_mul(F, res, res, acc);
      e >>= 1;
      if (e == 0 && i == NL - 1) break;
      fe_sqr(F, acc, acc);
    }
  }
  out = res;
}

static void fe_pow_u64(const FieldCtx &F, Fe &out, const Fe &base, u64 e) {
  Fe acc = base;
  Fe res = F.one_m;
  while (e) {
    if (e & 1) fe_mul(F, res, res, acc);
    e >>= 1;
    if (e) fe_sqr(F, acc, acc);
  }
  out = res;
}

static inline void fe_inv(const FieldCtx &F, Fe &out, const Fe &a) {
  if (fe_is_zero(a)) { out = a; return; }  // 0 -> 0 (batch_inversion semantics)
  fe_pow(F, out, a, F.p_minus_2);
}

// batch inversion (Montgomery's trick) — single-core hot path uses this
// like ark_ff::batch_inversion (fftree.rs:236)
static void fe_batch_inv(const FieldCtx &F, Fe *vals, size_t n) {
  std::vector<Fe> prefix(n + 1);
  prefix[0] = F.one_m;
  for (size_t i = 0; i < n; ++i) {
    if (fe_is_zero(vals[i])) prefix[i + 1] = prefix[i];
    else fe_mul(F, prefix[i + 1], prefix[i], vals[i]);
  }
  Fe acc;
  fe_inv(F, acc, prefix[n]);
  for (size_t i = n; i-- > 0;) {
    if (fe_is_zero(vals[i])) continue;
    Fe item = vals[i];
    fe_mul(F, vals[i], acc, prefix[i]);
    fe_mul(F, acc, acc, item);
  }
}

static void ctx_init(FieldCtx &F, const u8 *p_le) {
  std::memcpy(F.p.v, p_le, 32);
  // inv = -p^-1 mod 2^64 via Newton iteration
  u64 p0 = F.p.v[0];
  u64 x = 1;
  for (int i = 0; i < 6; ++i) x *= 2 - p0 * x;
  F.inv = (u64)(0 - x);
  // r = 2^256 mod p by repeated doubling of (2^255 mod p)... simpler:
  // start with 1, double 256 times mod p
  Fe r;
  std::memset(r.v, 0, sizeof(Fe));
  r.v[0] = 1;
  for (int i = 0; i < 256; ++i) {
    u64 carry = fe_add_raw(r, r, r);
    if (carry || fe_cmp(r, F.p) >= 0) {
      Fe t;
      fe_sub_raw(t, r, F.p);
      r = t;
    }
  }
  F.one_m = r;
  // r2 = r * r mod p: double one_m 256 more times
  Fe r2 = r;
  for (int i = 0; i < 256; ++i) {
    u64 carry = fe_add_raw(r2, r2, r2);
    if (carry || fe_cmp(r2, F.p) >= 0) {
      Fe t;
      fe_sub_raw(t, r2, F.p);
      r2 = t;
    }
  }
  F.r2 = r2;
  Fe two;
  std::memset(two.v, 0, sizeof(Fe));
  two.v[0] = 2;
  fe_sub_raw(F.p_minus_2, F.p, two);
}

static inline void to_mont(const FieldCtx &F, Fe &out, const Fe &a) {
  fe_mul(F, out, a, F.r2);
}

static inline void from_mont(const FieldCtx &F, Fe &out, const Fe &a) {
  Fe one;
  std::memset(one.v, 0, sizeof(Fe));
  one.v[0] = 1;
  fe_mul(F, out, a, one);
}

// ---------------------------------------------------------------- tree

struct RMap {
  std::vector<Fe> num;  // montgomery-form coefficients, low-first
  std::vector<Fe> den;
};

struct SizeTables {
  // selected butterfly matrices per depth: [depth][pair],
  // each entry 4 coefficients (2x2 row-major)
  std::vector<std::vector<Fe>> dec_s0, dec_s1, rec_s0, rec_s1;
  std::vector<Fe> leaves;
  std::vector<Fe> xnn, xnn_inv, z0_s1, z1_s0, z0i_s1, z1i_s0, z00, z11;
};

struct Tree {
  FieldCtx F;
  u64 n;
  std::vector<RMap> maps;
  std::vector<std::vector<Fe>> f_layers;  // [layer][pos], layer 0 = leaves
  // tables indexed by log2(size), sizes 2..n -> index 1..log2(n)
  std::vector<SizeTables> tabs;

  SizeTables &tab(u64 size) { return tabs[63 - __builtin_clzll(size)]; }
};

static int ilog2_u64(u64 x) { return 63 - __builtin_clzll(x); }

// EXTEND, iterative butterfly (semantics: fftree.rs:72-126; shape: the
// flat formulation of ecfft_tpu/ops/core.py::extend). moiety 1 = "input
// on S0, output on S1".
static void tree_extend(Tree &T, u64 tree_size, const Fe *in, Fe *out,
                        int moiety) {
  u64 m = tree_size / 2;
  SizeTables &st = T.tab(tree_size);
  std::vector<Fe> x(in, in + m);
  std::vector<Fe> y(m);
  int levels = ilog2_u64(m);
  for (int d = 0; d < levels; ++d) {
    u64 half = m >> (d + 1);
    auto &mats = (moiety == 0) ? st.dec_s0[d] : st.dec_s1[d];
    for (u64 p = 0; p < m; ++p) {
      u64 partner = p ^ half;
      const Fe *M = &mats[4 * (p & (half - 1))];
      const Fe &cs = (p & half) ? M[3] : M[0];
      const Fe &cp = (p & half) ? M[2] : M[1];
      Fe t1, t2;
      fe_mul(T.F, t1, cs, x[p]);
      fe_mul(T.F, t2, cp, x[partner]);
      fe_add(T.F, y[p], t1, t2);
    }
    std::swap(x, y);
  }
  for (int d = levels - 1; d >= 0; --d) {
    u64 half = m >> (d + 1);
    auto &mats = (moiety == 0) ? st.rec_s0[d] : st.rec_s1[d];
    for (u64 p = 0; p < m; ++p) {
      u64 partner = p ^ half;
      const Fe *M = &mats[4 * (p & (half - 1))];
      const Fe &cs = (p & half) ? M[3] : M[0];
      const Fe &cp = (p & half) ? M[2] : M[1];
      Fe t1, t2;
      fe_mul(T.F, t1, cs, x[p]);
      fe_mul(T.F, t2, cp, x[partner]);
      fe_add(T.F, y[p], t1, t2);
    }
    std::swap(x, y);
  }
  std::memcpy(out, x.data(), m * sizeof(Fe));
}

// MEXTEND (fftree.rs:128-141)
static void tree_mextend(Tree &T, u64 tree_size, const Fe *in, Fe *out,
                         int moiety) {
  u64 m = tree_size / 2;
  tree_extend(T, tree_size, in, out, moiety);
  SizeTables &st = T.tab(tree_size);
  const std::vector<Fe> &z = (moiety == 1) ? st.z0_s1 : st.z1_s0;
  for (u64 i = 0; i < m; ++i) fe_add(T.F, out[i], out[i], z[i]);
}

// ENTER (fftree.rs:143-167), bottom-up over block sizes
static void tree_enter(Tree &T, u64 n, const Fe *coeffs, Fe *out) {
  std::vector<Fe> x(coeffs, coeffs + n);
  std::vector<Fe> nxt(n), u1(n / 2 > 0 ? n / 2 : 1), v1(n / 2 > 0 ? n / 2 : 1);
  for (u64 size = 2; size <= n; size *= 2) {
    SizeTables &st = T.tab(size);
    u64 nb = n / size;
    for (u64 blk = 0; blk < nb; ++blk) {
      const Fe *u0 = &x[blk * size];
      const Fe *v0 = &x[blk * size + size / 2];
      tree_extend(T, size, u0, u1.data(), 1);
      tree_extend(T, size, v0, v1.data(), 1);
      Fe t;
      for (u64 i = 0; i < size / 2; ++i) {
        fe_mul(T.F, t, v0[i], st.xnn[2 * i]);
        fe_add(T.F, nxt[blk * size + 2 * i], u0[i], t);
        fe_mul(T.F, t, v1[i], st.xnn[2 * i + 1]);
        fe_add(T.F, nxt[blk * size + 2 * i + 1], u1[i], t);
      }
    }
    std::swap(x, nxt);
  }
  std::memcpy(out, x.data(), n * sizeof(Fe));
}

// REDC (fftree.rs:232-259); a0_inv may be null -> batch-invert even a's
static void tree_redc(Tree &T, u64 size, const Fe *evals, const Fe *a,
                      const Fe *a0_inv_opt, Fe *out, int moiety) {
  u64 half = size / 2;
  SizeTables &st = T.tab(size);
  std::vector<Fe> t0(half), g1(half), h1(half), h0(half);
  std::vector<Fe> a0inv;
  const Fe *a0_inv = a0_inv_opt;
  if (!a0_inv) {
    a0inv.resize(half);
    for (u64 i = 0; i < half; ++i) a0inv[i] = a[2 * i];
    fe_batch_inv(T.F, a0inv.data(), half);
    a0_inv = a0inv.data();
  }
  for (u64 i = 0; i < half; ++i) fe_mul(T.F, t0[i], evals[2 * i], a0_inv[i]);
  tree_extend(T, size, t0.data(), g1.data(), moiety == 1 ? 0 : 1);
  const std::vector<Fe> &zi = (moiety == 0) ? st.z0i_s1 : st.z1i_s0;
  for (u64 i = 0; i < half; ++i) {
    Fe t;
    fe_mul(T.F, t, g1[i], a[2 * i + 1]);
    fe_sub(T.F, t, evals[2 * i + 1], t);
    fe_mul(T.F, h1[i], t, zi[i]);
  }
  tree_extend(T, size, h1.data(), h0.data(), moiety);
  for (u64 i = 0; i < half; ++i) {
    out[2 * i] = h0[i];
    out[2 * i + 1] = h1[i];
  }
}

// MOD (fftree.rs:277-289)
static void tree_mod(Tree &T, u64 size, const Fe *evals, const Fe *a,
                     const Fe *a0_inv, const Fe *c, Fe *out) {
  std::vector<Fe> h(size);
  tree_redc(T, size, evals, a, a0_inv, h.data(), 0);
  for (u64 i = 0; i < size; ++i) fe_mul(T.F, h[i], h[i], c[i]);
  tree_redc(T, size, h.data(), a, a0_inv, out, 0);
}

// EXIT (fftree.rs:200-230), top-down in place
static void tree_exit(Tree &T, u64 n, const Fe *evals, Fe *out) {
  std::vector<Fe> x(evals, evals + n);
  std::vector<Fe> u(n), nxt(n);
  for (u64 size = n; size > 1; size /= 2) {
    SizeTables &st = T.tab(size);
    std::vector<Fe> xnn0_inv(size / 2);
    for (u64 i = 0; i < size / 2; ++i) xnn0_inv[i] = st.xnn_inv[2 * i];
    u64 nb = n / size;
    for (u64 blk = 0; blk < nb; ++blk) {
      Fe *cur = &x[blk * size];
      tree_mod(T, size, cur, st.xnn.data(), xnn0_inv.data(), st.z00.data(),
               u.data());
      Fe *dst = &nxt[blk * size];
      for (u64 i = 0; i < size / 2; ++i) {
        Fe u0 = u[2 * i];
        dst[i] = u0;
        Fe d;
        fe_sub(T.F, d, cur[2 * i], u0);
        fe_mul(T.F, dst[size / 2 + i], d, xnn0_inv[i]);
      }
    }
    std::swap(x, nxt);
  }
  std::memcpy(out, x.data(), n * sizeof(Fe));
}

// DEGREE (fftree.rs:169-198)
static u64 tree_degree(Tree &T, u64 n, const Fe *evals) {
  std::vector<Fe> x(evals, evals + n);
  u64 res = 0;
  for (u64 size = n; size > 1; size /= 2) {
    SizeTables &st = T.tab(size);
    u64 half = size / 2;
    std::vector<Fe> e0(half), e1(half), g1(half), t1(half), t0(half);
    for (u64 i = 0; i < half; ++i) {
      e0[i] = x[2 * i];
      e1[i] = x[2 * i + 1];
    }
    tree_extend(T, size, e0.data(), g1.data(), 1);
    bool low = true;
    for (u64 i = 0; i < half && low; ++i) low = fe_eq(g1[i], e1[i]);
    if (low) {
      std::copy(e0.begin(), e0.end(), x.begin());
    } else {
      for (u64 i = 0; i < half; ++i) {
        Fe d;
        fe_sub(T.F, d, e1[i], g1[i]);
        fe_mul(T.F, t1[i], d, st.z0i_s1[i]);
      }
      tree_extend(T, size, t1.data(), t0.data(), 0);
      std::copy(t0.begin(), t0.end(), x.begin());
      res += half;
    }
  }
  return res;
}

// VANISH (fftree.rs:291-316), bottom-up product tree
static void tree_vanish(Tree &T, u64 n_points, const Fe *pts, Fe *out) {
  SizeTables &t2 = T.tab(2);
  std::vector<Fe> x(2 * n_points);
  for (u64 i = 0; i < n_points; ++i) {
    fe_sub(T.F, x[2 * i], pts[i], t2.leaves[0]);
    fe_sub(T.F, x[2 * i + 1], pts[i], t2.leaves[1]);
  }
  // groups of current eval length `len` over tree size `len`
  std::vector<Fe> q(n_points), q1(n_points), nxt(2 * n_points);
  for (u64 len = 2; len < 2 * n_points; len *= 2) {
    u64 groups = 2 * n_points / len / 2;  // pairs of groups
    for (u64 g = 0; g < groups; ++g) {
      Fe *ga = &x[(2 * g) * len];
      Fe *gb = &x[(2 * g + 1) * len];
      for (u64 i = 0; i < len; ++i) fe_mul(T.F, q[i], ga[i], gb[i]);
      tree_mextend(T, 2 * len, q.data(), q1.data(), 1);
      Fe *dst = &nxt[g * 2 * len];
      for (u64 i = 0; i < len; ++i) {
        dst[2 * i] = q[i];
        dst[2 * i + 1] = q1[i];
      }
    }
    std::swap(x, nxt);
  }
  std::memcpy(out, x.data(), 2 * n_points * sizeof(Fe));
}

static void eval_poly(const FieldCtx &F, const std::vector<Fe> &coeffs,
                      const Fe &x, Fe &out) {
  Fe acc;
  std::memset(acc.v, 0, sizeof(Fe));
  for (size_t i = coeffs.size(); i-- > 0;) {
    fe_mul(F, acc, acc, x);
    fe_add(F, acc, acc, coeffs[i]);
  }
  out = acc;
}

// Construction bootstrap, same dependency order as fftree.rs:318-463 /
// ecfft_tpu/fftree.py::from_domain_layers, iterating sizes bottom-up.
static void tree_build(Tree &T) {
  u64 n = T.n;
  int logn = ilog2_u64(n);
  T.tabs.resize(logn + 1);
  for (int lg = 1; lg <= logn; ++lg) {
    u64 m = 1ull << lg;
    u64 stride = n / m;
    SizeTables &st = T.tabs[lg];
    // leaves
    st.leaves.resize(m);
    for (u64 i = 0; i < m; ++i) st.leaves[i] = T.f_layers[0][i * stride];
    // matrices per depth (Lemma 3.2, fftree.rs:338-363)
    int depths = lg - 1;
    st.dec_s0.resize(depths);
    st.dec_s1.resize(depths);
    st.rec_s0.resize(depths);
    st.rec_s1.resize(depths);
    for (int li = 0; li < depths; ++li) {
      u64 lay_len = m >> li;
      u64 d = lay_len / 2;
      u64 e = d / 2 - 1;
      std::vector<Fe> full_rec(4 * d), full_dec(4 * d);
      std::vector<Fe> dets(d);
      for (u64 i = 0; i < d; ++i) {
        const Fe &sa = T.f_layers[li][i * stride];
        const Fe &sb = T.f_layers[li][(i + d) * stride];
        Fe va, vb;
        eval_poly(T.F, T.maps[li].den, sa, va);
        eval_poly(T.F, T.maps[li].den, sb, vb);
        fe_pow_u64(T.F, va, va, e);
        fe_pow_u64(T.F, vb, vb, e);
        Fe *R = &full_rec[4 * i];
        R[0] = va;
        fe_mul(T.F, R[1], sa, va);
        R[2] = vb;
        fe_mul(T.F, R[3], sb, vb);
        Fe t1, t2;
        fe_mul(T.F, t1, R[0], R[3]);
        fe_mul(T.F, t2, R[1], R[2]);
        fe_sub(T.F, dets[i], t1, t2);
      }
      fe_batch_inv(T.F, dets.data(), d);
      for (u64 i = 0; i < d; ++i) {
        Fe *R = &full_rec[4 * i];
        Fe *D = &full_dec[4 * i];
        fe_mul(T.F, D[0], R[3], dets[i]);
        fe_mul(T.F, D[1], R[1], dets[i]);
        fe_neg(T.F, D[1], D[1]);
        fe_mul(T.F, D[2], R[2], dets[i]);
        fe_neg(T.F, D[2], D[2]);
        fe_mul(T.F, D[3], R[0], dets[i]);
      }
      // moiety selections (fftree.rs:87-91,108-112)
      u64 selc = d / 2;
      st.dec_s0[li].resize(4 * selc);
      st.dec_s1[li].resize(4 * selc);
      st.rec_s0[li].resize(4 * selc);
      st.rec_s1[li].resize(4 * selc);
      for (u64 i = 0; i < selc; ++i) {
        std::memcpy(&st.dec_s0[li][4 * i], &full_dec[4 * (2 * i + 1)],
                    4 * sizeof(Fe));
        std::memcpy(&st.dec_s1[li][4 * i], &full_dec[4 * (2 * i)],
                    4 * sizeof(Fe));
        std::memcpy(&st.rec_s0[li][4 * i], &full_rec[4 * (2 * i)],
                    4 * sizeof(Fe));
        std::memcpy(&st.rec_s1[li][4 * i], &full_rec[4 * (2 * i + 1)],
                    4 * sizeof(Fe));
      }
    }
    // xnn tables
    st.xnn.resize(m);
    for (u64 i = 0; i < m; ++i)
      fe_pow_u64(T.F, st.xnn[i], st.leaves[i], m / 2);
    st.xnn_inv = st.xnn;
    fe_batch_inv(T.F, st.xnn_inv.data(), m);

    if (m == 2) {
      st.z0_s1.resize(1);
      st.z1_s0.resize(1);
      fe_sub(T.F, st.z0_s1[0], st.leaves[1], st.leaves[0]);
      fe_sub(T.F, st.z1_s0[0], st.leaves[0], st.leaves[1]);
      st.z00.resize(2);
      st.z11.resize(2);
      fe_sqr(T.F, st.z00[0], st.leaves[0]);
      st.z00[1] = st.z00[0];
      fe_sqr(T.F, st.z11[0], st.leaves[1]);
      st.z11[1] = st.z11[0];
    } else {
      SizeTables &sub = T.tabs[lg - 1];
      u64 half = m / 2;
      // z0_s1 (fftree.rs:384-393)
      std::vector<Fe> a(half), b(half), ea(half), eb(half);
      for (u64 i = 0; i < half; ++i) {
        std::memset(a[i].v, 0, sizeof(Fe));
        std::memset(b[i].v, 0, sizeof(Fe));
      }
      for (u64 i = 0; i < half / 2; ++i) {
        a[2 * i + 1] = sub.z0_s1[i];
        b[2 * i] = sub.z1_s0[i];
      }
      tree_extend(T, m, a.data(), ea.data(), 1);
      tree_extend(T, m, b.data(), eb.data(), 1);
      st.z0_s1.resize(half);
      for (u64 i = 0; i < half; ++i) fe_mul(T.F, st.z0_s1[i], ea[i], eb[i]);
      // z1_s0 via vanish (fftree.rs:395-397) — vanish needs z0_s1 of this
      // size, already set above
      std::vector<Fe> s1(half), z1s(m);
      for (u64 i = 0; i < half; ++i) s1[i] = st.leaves[2 * i + 1];
      tree_vanish(T, half, s1.data(), z1s.data());
      st.z1_s0.resize(half);
      for (u64 i = 0; i < half; ++i) st.z1_s0[i] = z1s[2 * i];
    }
    st.z0i_s1 = st.z0_s1;
    fe_batch_inv(T.F, st.z0i_s1.data(), st.z0i_s1.size());
    st.z1i_s0 = st.z1_s0;
    fe_batch_inv(T.F, st.z1i_s0.data(), st.z1i_s0.size());

    if (m > 2) {
      SizeTables &sub = T.tabs[lg - 1];
      u64 half = m / 2;
      // z00 (fftree.rs:419-446)
      std::vector<Fe> xnnnn(m), xnnnn_inv(m);
      for (u64 i = 0; i < m; ++i)
        fe_pow_u64(T.F, xnnnn[i], st.leaves[i], m / 4);
      xnnnn_inv = xnnnn;
      fe_batch_inv(T.F, xnnnn_inv.data(), m);
      std::vector<Fe> sq0(half), rem0(half), rem1(half);
      for (u64 i = 0; i < half; ++i)
        fe_mul(T.F, sq0[i], sub.z00[i], sub.z11[i]);
      std::vector<Fe> sub_xnn0_inv(half / 2);
      for (u64 i = 0; i < half / 2; ++i) sub_xnn0_inv[i] = sub.xnn_inv[2 * i];
      tree_mod(T, half, sq0.data(), sub.xnn.data(), sub_xnn0_inv.data(),
               sub.z00.data(), rem0.data());
      tree_extend(T, m, rem0.data(), rem1.data(), 1);
      std::vector<Fe> z00_rem_xnnnn(m), z0s(m), tmp(m);
      for (u64 i = 0; i < half; ++i) {
        z00_rem_xnnnn[2 * i] = rem0[i];
        z00_rem_xnnnn[2 * i + 1] = rem1[i];
        std::memset(z0s[2 * i].v, 0, sizeof(Fe));
        z0s[2 * i + 1] = st.z0_s1[i];
      }
      for (u64 i = 0; i < m; ++i) {
        Fe d;
        fe_sub(T.F, d, z0s[i], st.xnn[i]);
        fe_sqr(T.F, d, d);
        fe_sub(T.F, d, d, z00_rem_xnnnn[i]);
        fe_mul(T.F, tmp[i], d, xnnnn_inv[i]);
      }
      std::vector<Fe> xnnnn0_inv(half);
      for (u64 i = 0; i < half; ++i) xnnnn0_inv[i] = xnnnn_inv[2 * i];
      std::vector<Fe> hi_rem(m);
      tree_mod(T, m, tmp.data(), xnnnn.data(), xnnnn0_inv.data(),
               z00_rem_xnnnn.data(), hi_rem.data());
      st.z00.resize(m);
      for (u64 i = 0; i < m; ++i) {
        Fe t;
        fe_mul(T.F, t, xnnnn[i], hi_rem[i]);
        fe_add(T.F, st.z00[i], z00_rem_xnnnn[i], t);
      }
      // z11 (fftree.rs:448-452)
      std::vector<Fe> z1s(m), z11in(m);
      for (u64 i = 0; i < half; ++i) {
        z1s[2 * i] = st.z1_s0[i];
        std::memset(z1s[2 * i + 1].v, 0, sizeof(Fe));
      }
      for (u64 i = 0; i < m; ++i) {
        Fe d;
        fe_sub(T.F, d, z1s[i], st.xnn[i]);
        fe_sqr(T.F, z11in[i], d);
      }
      std::vector<Fe> xnn0_inv(half);
      for (u64 i = 0; i < half; ++i) xnn0_inv[i] = st.xnn_inv[2 * i];
      st.z11.resize(m);
      tree_mod(T, m, z11in.data(), st.xnn.data(), xnn0_inv.data(),
               st.z00.data(), st.z11.data());
    }
  }
}

// ------------------------------------------------------ FIND_CURVE

// Legendre symbol via Euler's criterion; returns 1 (QR), -1 (non), 0.
static int fe_legendre(const FieldCtx &F, const Fe &a) {
  if (fe_is_zero(a)) return 0;
  // (p-1)/2: shift p right by one
  Fe e;
  u64 carry = 0;
  for (int i = NL - 1; i >= 0; --i) {
    u64 v = F.p.v[i];
    e.v[i] = (v >> 1) | (carry << 63);
    carry = v & 1;
  }
  Fe am, r;
  to_mont(F, am, a);
  fe_pow(F, r, am, e);
  Fe one = F.one_m;
  if (fe_eq(r, one)) return 1;
  return -1;
}

// Tonelli–Shanks square root (montgomery in/out); false if non-residue.
static bool fe_sqrt(const FieldCtx &F, Fe &out, const Fe &a) {
  if (fe_is_zero(a)) { out = a; return true; }
  // q, s with p-1 = q·2^s
  Fe q = F.p;
  q.v[0] -= 1;  // p odd, no borrow
  int s = 0;
  while (!(q.v[0] & 1)) {
    u64 carry = 0;
    for (int i = NL - 1; i >= 0; --i) {
      u64 v = q.v[i];
      q.v[i] = (v >> 1) | (carry << 63);
      carry = v & 1;
    }
    ++s;
  }
  // find a non-residue z (deterministic walk)
  Fe z;
  std::memset(z.v, 0, sizeof(Fe));
  z.v[0] = 2;
  Fe zc = z;
  while (true) {
    if (fe_legendre(F, zc) == -1) break;
    zc.v[0] += 1;
  }
  Fe zm, c, t, r, e1;
  to_mont(F, zm, zc);
  fe_pow(F, c, zm, q);
  fe_pow(F, t, a, q);
  // r = a^((q+1)/2)
  Fe q1 = q;
  u64 carry2 = 1;
  for (int i = 0; i < NL && carry2; ++i) {
    q1.v[i] += carry2;
    carry2 = (q1.v[i] == 0);
  }
  u64 carry3 = 0;
  for (int i = NL - 1; i >= 0; --i) {
    u64 v = q1.v[i];
    q1.v[i] = (v >> 1) | (carry3 << 63);
    carry3 = v & 1;
  }
  fe_pow(F, r, a, q1);
  int m = s;
  while (!fe_eq(t, F.one_m)) {
    Fe t2 = t;
    int i = 0;
    while (!fe_eq(t2, F.one_m)) {
      fe_sqr(F, t2, t2);
      ++i;
      if (i >= m) return false;  // non-residue
    }
    Fe b = c;
    for (int j = 0; j < m - i - 1; ++j) fe_sqr(F, b, b);
    m = i;
    fe_sqr(F, c, b);
    fe_mul(F, t, t, c);
    fe_mul(F, r, r, b);
  }
  out = r;
  return true;
}

struct Xorshift {
  u64 s;
  u64 next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  Fe next_fe(const FieldCtx &F) {
    Fe r;
    while (true) {
      for (int i = 0; i < NL; ++i) r.v[i] = next();
      // mask to modulus bit-length, retry if >= p
      int topbits = 64;
      for (int i = NL - 1; i >= 0; --i) {
        if (F.p.v[i]) { topbits = 64 - __builtin_clzll(F.p.v[i]); break; }
        r.v[i] = 0;
      }
      int top_idx = NL - 1;
      while (top_idx > 0 && F.p.v[top_idx] == 0) --top_idx;
      if (topbits < 64)
        r.v[top_idx] &= (1ull << topbits) - 1;
      if (fe_cmp(r, F.p) < 0) return r;
    }
  }
};

// x(2P) from x(P) on y² = x(x² + ax + B) (find_curve.rs:11-19); montgomery.
static bool fc_double_x(const FieldCtx &F, Fe &out, const Fe &px,
                        const Fe &a, const Fe &bb) {
  Fe pxpx, t, pypy;
  fe_sqr(F, pxpx, px);
  fe_mul(F, t, a, px);
  fe_add(F, t, t, pxpx);
  fe_add(F, t, t, bb);
  fe_mul(F, pypy, px, t);
  if (fe_is_zero(pypy)) return false;
  Fe num, den, deninv;
  fe_sub(F, num, pxpx, bb);
  fe_sqr(F, num, num);
  fe_add(F, den, pypy, pypy);
  fe_add(F, den, den, den);
  fe_inv(F, deninv, den);
  fe_mul(F, out, num, deninv);
  return true;
}

// roots of x² + bx + c (monic), montgomery (find_curve.rs:35-44)
static bool fc_quad_roots(const FieldCtx &F, Fe r[2], const Fe &b,
                          const Fe &c) {
  Fe disc, t;
  fe_sqr(F, disc, b);
  fe_add(F, t, c, c);
  fe_add(F, t, t, t);
  fe_sub(F, disc, disc, t);
  Fe s;
  if (!fe_sqrt(F, s, disc)) return false;
  // roots = (-b ± s)/2
  Fe two, twoinv;
  std::memset(two.v, 0, sizeof(Fe));
  two.v[0] = 2;
  to_mont(F, two, two);
  fe_inv(F, twoinv, two);
  Fe nb;
  fe_neg(F, nb, b);
  Fe u;
  fe_add(F, u, nb, s);
  fe_mul(F, r[0], u, twoinv);
  fe_sub(F, u, nb, s);
  fe_mul(F, r[1], u, twoinv);
  return true;
}

// half-point x (find_curve.rs:25-31,49-56); montgomery.
static bool fc_half_x(const FieldCtx &F, Fe &out, const Fe &qx, const Fe &a,
                      const Fe &bb) {
  Fe delta, t;
  fe_sqr(F, delta, qx);
  fe_mul(F, t, a, qx);
  fe_add(F, delta, delta, t);
  fe_add(F, delta, delta, bb);
  Fe ds;
  if (!fe_sqrt(F, ds, delta)) return false;
  for (int i = 1; i <= 2; ++i) {
    // x_coeff = -(2qx ± 2ds)
    Fe xc;
    fe_add(F, xc, qx, qx);
    Fe dd;
    fe_add(F, dd, ds, ds);
    if (i == 1) fe_sub(F, xc, xc, dd);
    else fe_add(F, xc, xc, dd);
    fe_neg(F, xc, xc);
    Fe roots[2];
    if (!fc_quad_roots(F, roots, xc, bb)) continue;
    for (int j = 0; j < 2; ++j) {
      Fe yy, u;
      fe_sqr(F, u, roots[j]);
      fe_mul(F, t, a, roots[j]);
      fe_add(F, u, u, t);
      fe_add(F, u, u, bb);
      fe_mul(F, yy, roots[j], u);
      Fe dummy;
      if (fe_sqrt(F, dummy, yy)) { out = roots[j]; return true; }
    }
  }
  return false;
}

// cyclic 2-Sylow (find_curve.rs:190-218); montgomery in, returns adicity.
static int fc_cyclic_sylow(const FieldCtx &F, Fe &gen_x, const Fe &a,
                           const Fe &bb) {
  Fe disc, t;
  fe_sqr(F, disc, a);
  fe_add(F, t, bb, bb);
  fe_add(F, t, t, t);
  fe_sub(F, disc, disc, t);
  if (fe_is_zero(disc)) return 0;
  Fe b, ds;
  if (!fe_sqrt(F, b, bb)) return 0;
  if (fe_sqrt(F, ds, disc)) return 0;  // disc QR -> non-cyclic
  Fe b2, apb, amb, p4x, dummy;
  fe_add(F, b2, b, b);
  fe_add(F, apb, a, b2);
  fe_sub(F, amb, a, b2);
  if (fe_sqrt(F, dummy, apb)) p4x = b;
  else if (fe_sqrt(F, dummy, amb)) fe_neg(F, p4x, b);
  else return 0;  // unreachable mathematically
  Fe dx;
  if (!fc_double_x(F, dx, p4x, a, bb)) {
    std::memset(gen_x.v, 0, sizeof(Fe));
    return 1;
  }
  int k = 2;
  Fe acc = p4x;
  Fe h;
  while (fc_half_x(F, h, acc, a, bb)) {
    ++k;
    acc = h;
  }
  gen_x = acc;
  return k;
}

// --------------------------------------------------------------- Schoof
//
// Native point counting (the hot math of /root/reference/examples/
// schoofs.rs:30-138): per small prime l this computes the Frobenius
// trace t mod l by endomorphism arithmetic in F_p[x]/(psi_l); the
// big-integer CRT accumulation (schoofs.rs:55-62) stays in Python where
// arbitrary-precision ints are free. Polynomials are low-degree-first
// vectors of Montgomery-form field elements.

typedef std::vector<Fe> Poly;

static void ptrim(Poly &f) {
  while (!f.empty() && fe_is_zero(f.back())) f.pop_back();
}

static int pdeg(const Poly &f) { return (int)f.size() - 1; }

static Poly padd(const FieldCtx &F, const Poly &a, const Poly &b) {
  Poly r(std::max(a.size(), b.size()));
  for (size_t i = 0; i < r.size(); ++i) {
    Fe x, y;
    std::memset(x.v, 0, sizeof(Fe));
    std::memset(y.v, 0, sizeof(Fe));
    if (i < a.size()) x = a[i];
    if (i < b.size()) y = b[i];
    fe_add(F, r[i], x, y);
  }
  ptrim(r);
  return r;
}

static Poly psub(const FieldCtx &F, const Poly &a, const Poly &b) {
  Poly r(std::max(a.size(), b.size()));
  for (size_t i = 0; i < r.size(); ++i) {
    Fe x, y;
    std::memset(x.v, 0, sizeof(Fe));
    std::memset(y.v, 0, sizeof(Fe));
    if (i < a.size()) x = a[i];
    if (i < b.size()) y = b[i];
    fe_sub(F, r[i], x, y);
  }
  ptrim(r);
  return r;
}

// schoolbook base case; kept untrimmed (exact length a+b-1) for the
// recursive Karatsuba combiner
static void pmul_base(const FieldCtx &F, const Fe *a, size_t na,
                      const Fe *b, size_t nb, Fe *r) {
  std::memset((void *)r, 0, (na + nb - 1) * sizeof(Fe));
  for (size_t i = 0; i < na; ++i) {
    if (fe_is_zero(a[i])) continue;
    for (size_t j = 0; j < nb; ++j) {
      Fe t;
      fe_mul(F, t, a[i], b[j]);
      fe_add(F, r[i + j], r[i + j], t);
    }
  }
}

static const size_t KARA_THRESH = 24;

// r[0 .. na+nb-2] = a * b, Karatsuba above KARA_THRESH. Schoof's ring
// elements reach degree ~(l^2)/2; schoolbook there is the difference
// between minutes and hours per Frobenius power at 256-bit p.
static void pmul_rec(const FieldCtx &F, const Fe *a, size_t na,
                     const Fe *b, size_t nb, Fe *r) {
  if (na > nb) { std::swap(a, b); std::swap(na, nb); }
  if (na == 0) return;
  if (na < KARA_THRESH) {
    pmul_base(F, a, na, b, nb, r);
    return;
  }
  size_t h = (nb + 1) / 2;  // split the longer operand
  if (na <= h) {
    // a fits entirely in the low half: r = a*b_lo + x^h * a*b_hi
    std::memset((void *)r, 0, (na + nb - 1) * sizeof(Fe));
    std::vector<Fe> t(na + h - 1);
    pmul_rec(F, a, na, b, h, t.data());
    for (size_t i = 0; i < t.size(); ++i) fe_add(F, r[i], r[i], t[i]);
    t.assign(na + (nb - h) - 1, Fe());
    pmul_rec(F, a, na, b + h, nb - h, t.data());
    for (size_t i = 0; i < t.size(); ++i)
      fe_add(F, r[h + i], r[h + i], t[i]);
    return;
  }
  // both split: (a0 + x^h a1)(b0 + x^h b1)
  size_t na1 = na - h, nb1 = nb - h;
  std::memset((void *)r, 0, (na + nb - 1) * sizeof(Fe));
  std::vector<Fe> z0(2 * h - 1), z2(na1 + nb1 - 1);
  pmul_rec(F, a, h, b, h, z0.data());
  pmul_rec(F, a + h, na1, b + h, nb1, z2.data());
  // (a0+a1)(b0+b1)
  std::vector<Fe> sa(h), sb(h);
  for (size_t i = 0; i < h; ++i) {
    Fe hi;
    std::memset(hi.v, 0, sizeof(Fe));
    if (i < na1) hi = a[h + i];
    fe_add(F, sa[i], a[i], hi);
    std::memset(hi.v, 0, sizeof(Fe));
    if (i < nb1) hi = b[h + i];
    fe_add(F, sb[i], b[i], hi);
  }
  std::vector<Fe> z1(2 * h - 1);
  pmul_rec(F, sa.data(), h, sb.data(), h, z1.data());
  for (size_t i = 0; i < z1.size(); ++i) {
    if (i < z0.size()) fe_sub(F, z1[i], z1[i], z0[i]);
    if (i < z2.size()) fe_sub(F, z1[i], z1[i], z2[i]);
  }
  for (size_t i = 0; i < z0.size(); ++i) fe_add(F, r[i], r[i], z0[i]);
  for (size_t i = 0; i < z1.size(); ++i)
    fe_add(F, r[h + i], r[h + i], z1[i]);
  for (size_t i = 0; i < z2.size(); ++i)
    fe_add(F, r[2 * h + i], r[2 * h + i], z2[i]);
}

static Poly pmul(const FieldCtx &F, const Poly &a, const Poly &b) {
  if (a.empty() || b.empty()) return {};
  Poly r(a.size() + b.size() - 1);
  pmul_rec(F, a.data(), a.size(), b.data(), b.size(), r.data());
  ptrim(r);
  return r;
}

// low ``k`` coefficients of a*b (series product)
static Poly pmullo(const FieldCtx &F, const Poly &a, const Poly &b,
                   size_t k) {
  Poly r = pmul(F, a, b);
  if (r.size() > k) r.resize(k);
  ptrim(r);
  return r;
}

static Poly pscale(const FieldCtx &F, const Poly &a, const Fe &c) {
  Poly r(a.size());
  for (size_t i = 0; i < a.size(); ++i) fe_mul(F, r[i], a[i], c);
  ptrim(r);
  return r;
}

// r = a mod b (b nonzero); quotient discarded
static Poly pmod(const FieldCtx &F, const Poly &a, const Poly &b) {
  Poly r = a;
  ptrim(r);
  int db = pdeg(b);
  Fe lead_inv;
  fe_inv(F, lead_inv, b[db]);
  while (pdeg(r) >= db) {
    int k = pdeg(r) - db;
    Fe q;
    fe_mul(F, q, r.back(), lead_inv);
    for (int i = 0; i <= db; ++i) {
      Fe t;
      fe_mul(F, t, q, b[i]);
      fe_sub(F, r[i + k], r[i + k], t);
    }
    ptrim(r);
  }
  return r;
}

// ------------------------- fixed-modulus Barrett reduction (Schoof hot path)
//
// Schoof reduces thousands of degree <2d products by ONE modulus psi_l
// (degree d ~ l^2/2). Long division is O(d^2) per reduction; with the
// Newton-series inverse of the reversed modulus precomputed once, each
// reduction is two Karatsuba products (quotient estimate + back-multiply).

struct BarCtx {
  Poly m;     // monic modulus
  Poly rinv;  // rev(m)^{-1} mod x^dm
  int dm;     // deg m
};

// series inverse of r (r[0] must be 1) modulo x^k, by Newton iteration
static Poly pinv_series(const FieldCtx &F, const Poly &r, size_t k) {
  Poly g = {F.one_m};
  size_t prec = 1;
  while (prec < k) {
    prec = std::min(2 * prec, k);
    Poly rg = pmullo(F, r, g, prec);
    Poly t(prec);
    for (auto &c : t) std::memset(c.v, 0, sizeof(Fe));
    Fe two;
    fe_add(F, two, F.one_m, F.one_m);
    if (!rg.empty()) {
      for (size_t i = 0; i < rg.size(); ++i) fe_neg(F, t[i], rg[i]);
      fe_add(F, t[0], t[0], two);
    } else {
      t[0] = two;
    }
    g = pmullo(F, g, t, prec);
  }
  return g;
}

static Poly prev_fixed(const Poly &a, size_t len) {
  Poly r(len);
  for (auto &c : r) std::memset(c.v, 0, sizeof(Fe));
  for (size_t i = 0; i < a.size() && i < len; ++i) r[len - 1 - i] = a[i];
  return r;
}

static void bar_init(const FieldCtx &F, BarCtx &C, const Poly &m) {
  C.m = m;
  ptrim(C.m);
  C.dm = pdeg(C.m);
  if (C.dm <= 0) { C.rinv = {}; return; }
  if (!fe_eq(C.m.back(), F.one_m)) {  // monic-normalize (same ideal)
    Fe li;
    fe_inv(F, li, C.m.back());
    C.m = pscale(F, C.m, li);
  }
  Poly rev = prev_fixed(C.m, C.dm + 1);
  C.rinv = pinv_series(F, rev, (size_t)C.dm);
}

// a mod C.m for deg a <= 2*dm - 2 (a product of two residues)
static Poly bar_red(const FieldCtx &F, const BarCtx &C, Poly a) {
  ptrim(a);
  int da = pdeg(a);
  if (da < C.dm) return a;
  size_t k = (size_t)(da - C.dm + 1);  // quotient length, <= dm - 1
  Poly q_rev = pmullo(F, prev_fixed(a, (size_t)da + 1), C.rinv, k);
  Poly q = prev_fixed(q_rev, k);
  Poly qm = pmullo(F, q, C.m, (size_t)C.dm);
  Poly r((size_t)C.dm);
  for (int i = 0; i < C.dm; ++i) {
    Fe lo, s;
    std::memset(lo.v, 0, sizeof(Fe));
    std::memset(s.v, 0, sizeof(Fe));
    if ((size_t)i < a.size()) lo = a[(size_t)i];
    if ((size_t)i < qm.size()) s = qm[(size_t)i];
    fe_sub(F, r[(size_t)i], lo, s);
  }
  ptrim(r);
  return r;
}

static Poly pgcd(const FieldCtx &F, Poly a, Poly b) {
  ptrim(a);
  ptrim(b);
  while (!b.empty()) {
    Poly r = pmod(F, a, b);
    a = b;
    b = r;
  }
  if (!a.empty()) {  // monic-normalize
    Fe li;
    fe_inv(F, li, a.back());
    a = pscale(F, a, li);
  }
  return a;
}

// extended euclid: returns (s, g) with s*f = g (mod m), g monic.
// ring inverse when deg g == 0 (then g == 1 and s = f^-1); otherwise g
// is a discovered factor of the modulus (schoofs.rs:115-128).
static void pxgcd(const FieldCtx &F, const Poly &f, const Poly &m,
                  Poly &s_out, Poly &g_out) {
  Poly r0 = m, r1 = f;
  Poly s0 = {}, s1 = {F.one_m};
  ptrim(r0);
  ptrim(r1);
  while (!r1.empty()) {
    // divide r0 by r1: track quotient to update s
    int db = pdeg(r1);
    Fe lead_inv;
    fe_inv(F, lead_inv, r1[db]);
    Poly r = r0;
    Poly q(std::max(pdeg(r0) - db + 1, 0));
    for (auto &c : q) std::memset(c.v, 0, sizeof(Fe));
    while (pdeg(r) >= db) {
      int k = pdeg(r) - db;
      Fe qc;
      fe_mul(F, qc, r.back(), lead_inv);
      fe_add(F, q[k], q[k], qc);
      for (int i = 0; i <= db; ++i) {
        Fe t;
        fe_mul(F, t, qc, r1[i]);
        fe_sub(F, r[i + k], r[i + k], t);
      }
      ptrim(r);
    }
    ptrim(q);
    Poly s2 = psub(F, s0, pmul(F, q, s1));
    r0 = r1;
    r1 = r;
    s0 = s1;
    s1 = s2;
  }
  Fe li;
  fe_inv(F, li, r0.back());
  g_out = pscale(F, r0, li);
  s_out = pscale(F, s0, li);
}

// f^e mod m, e a 256-bit little-endian exponent; the per-bit reductions
// go through a Barrett context built once for m
static Poly ppowmod(const FieldCtx &F, const Poly &f, const Fe &e,
                    const Poly &m) {
  BarCtx C;
  bar_init(F, C, m);
  int top = -1;
  for (int i = NL * 64 - 1; i >= 0; --i)
    if ((e.v[i / 64] >> (i % 64)) & 1) { top = i; break; }
  Poly res = {F.one_m};
  if (top < 0) return pmod(F, res, C.m);
  Poly acc = pmod(F, f, C.m);
  for (int i = 0; i <= top; ++i) {
    if ((e.v[i / 64] >> (i % 64)) & 1)
      res = bar_red(F, C, pmul(F, res, acc));
    if (i < top) acc = bar_red(F, C, pmul(F, acc, acc));
  }
  return res;
}

static Fe fe_small(const FieldCtx &F, u64 v) {
  Fe t;
  std::memset(t.v, 0, sizeof(Fe));
  t.v[0] = v;
  Fe m;
  to_mont(F, m, t);
  return m;
}

// x-only division polynomials f_1..f_lmax with the parity convention of
// ecfft_tpu/schoof.py (odd n: psi_n = f_n; even n: psi_n = y*f_n),
// every y^2 replaced by Fc = x^3 + Ax + B (schoofs.rs:370-431)
static std::vector<Poly> division_polys(const FieldCtx &F, const Fe &A,
                                        const Fe &B, int lmax) {
  Poly Fc = {B, A, fe_small(F, 0), F.one_m};
  ptrim(Fc);
  Poly FF = pmul(F, Fc, Fc);
  std::vector<Poly> f(std::max(lmax + 1, 5));
  f[0] = {};
  f[1] = {F.one_m};
  f[2] = {fe_small(F, 2)};
  {
    // psi3 = 3x^4 + 6Ax^2 + 12Bx - A^2
    Fe a2, t;
    fe_mul(F, a2, A, A);
    Poly p3(5);
    fe_neg(F, p3[0], a2);
    fe_mul(F, p3[1], fe_small(F, 12), B);
    fe_mul(F, p3[2], fe_small(F, 6), A);
    std::memset(p3[3].v, 0, sizeof(Fe));
    p3[4] = fe_small(F, 3);
    (void)t;
    f[3] = p3;
  }
  {
    // psi4 = y*4*(x^6 + 5Ax^4 + 20Bx^3 - 5A^2x^2 - 4ABx - 8B^2 - A^3)
    Fe a2, a3, b2, t;
    fe_mul(F, a2, A, A);
    fe_mul(F, a3, a2, A);
    fe_mul(F, b2, B, B);
    Poly p4(7);
    fe_mul(F, t, fe_small(F, 8), b2);
    fe_add(F, t, t, a3);
    fe_neg(F, t, t);
    fe_mul(F, p4[0], fe_small(F, 4), t);
    fe_mul(F, t, A, B);
    fe_mul(F, t, t, fe_small(F, 4));
    fe_neg(F, t, t);
    fe_mul(F, p4[1], fe_small(F, 4), t);
    fe_mul(F, t, fe_small(F, 5), a2);
    fe_neg(F, t, t);
    fe_mul(F, p4[2], fe_small(F, 4), t);
    fe_mul(F, p4[3], fe_small(F, 80), B);
    fe_mul(F, p4[4], fe_small(F, 20), A);
    std::memset(p4[5].v, 0, sizeof(Fe));
    p4[6] = fe_small(F, 4);
    f[4] = p4;
  }
  Fe half;
  fe_inv(F, half, fe_small(F, 2));
  for (int n = 5; n <= lmax; ++n) {
    int m = n / 2;
    if (n % 2 == 1) {
      Poly m3 = pmul(F, f[m], pmul(F, f[m], f[m]));
      Poly a = pmul(F, f[m + 2], m3);
      Poly p13 = pmul(F, f[m + 1], pmul(F, f[m + 1], f[m + 1]));
      Poly b = pmul(F, f[m - 1], p13);
      if (m % 2 == 1)
        f[n] = psub(F, a, pmul(F, b, FF));
      else
        f[n] = psub(F, pmul(F, a, FF), b);
    } else {
      Poly a = pmul(F, f[m + 2], pmul(F, f[m - 1], f[m - 1]));
      Poly b = pmul(F, f[m - 2], pmul(F, f[m + 1], f[m + 1]));
      Poly inner = psub(F, a, b);
      f[n] = pscale(F, pmul(F, f[m], inner), half);
    }
  }
  return f;
}

// endomorphism (a(x), y*b(x)) in F_p[x]/(mod) (schoofs.rs:142-273);
// `inf` marks the zero endomorphism. Factor discovery aborts the
// computation: `factor` is set and callers restart on the new modulus.
struct SEndo {
  Poly a, b;
  bool inf;
};

struct SchoofCtx {
  const FieldCtx *F;
  Poly modulus;
  BarCtx bar;  // Barrett context for `modulus` (monic-normalized)
  Poly Fc;  // x^3 + Ax + B
  Poly factor;  // non-empty => restart with this modulus factor
  bool failed;
};

static Poly sred(SchoofCtx &C, const Poly &f) {
  if (pdeg(f) <= 2 * C.bar.dm - 2) return bar_red(*C.F, C.bar, f);
  return pmod(*C.F, f, C.bar.m);
}

static bool sinv(SchoofCtx &C, const Poly &f, Poly &out) {
  Poly s, g;
  pxgcd(*C.F, sred(C, f), C.bar.m, s, g);
  if (pdeg(g) != 0) {
    C.factor = g;
    C.failed = true;
    return false;
  }
  out = sred(C, s);
  return true;
}

static bool peq(const Poly &a, const Poly &b) {
  if (a.size() != b.size()) return false;
  for (size_t i = 0; i < a.size(); ++i)
    if (!fe_eq(a[i], b[i])) return false;
  return true;
}

static SEndo endo_add(SchoofCtx &C, const SEndo &e1, const SEndo &e2) {
  const FieldCtx &F = *C.F;
  if (C.failed || e1.inf) return e2;
  if (e2.inf) return e1;
  SEndo out;
  out.inf = false;
  Poly c;
  if (peq(e1.a, e2.a)) {
    Poly negb2(e2.b.size());
    for (size_t i = 0; i < e2.b.size(); ++i) fe_neg(F, negb2[i], e2.b[i]);
    ptrim(negb2);
    if (peq(e1.b, negb2)) {
      out.inf = true;  // opposite points
      return out;
    }
    if (peq(e1.b, e2.b)) {
      // tangent: c = (3a^2 + A) / (2*Fc*b)
      Poly aa = pmul(F, e1.a, e1.a);
      Poly num = pscale(F, aa, fe_small(F, 3));
      Poly acoef = {C.Fc.size() > 1 ? C.Fc[1] : fe_small(F, 0)};
      num = sred(C, padd(F, num, acoef));
      Poly den = pscale(F, pmul(F, C.Fc, e1.b), fe_small(F, 2));
      den = sred(C, den);
      Poly deninv;
      if (!sinv(C, den, deninv)) return out;
      c = sred(C, pmul(F, num, deninv));
    } else {
      out.inf = true;  // distinct endos sharing x (unreachable branch)
      return out;
    }
  } else {
    Poly num = psub(F, e2.b, e1.b);
    Poly den = psub(F, e2.a, e1.a);
    Poly deninv;
    if (!sinv(C, sred(C, den), deninv)) return out;
    c = sred(C, pmul(F, sred(C, num), deninv));
  }
  Poly cc = sred(C, pmul(F, c, c));
  Poly x3 = psub(F, sred(C, pmul(F, cc, C.Fc)), padd(F, e1.a, e2.a));
  x3 = sred(C, x3);
  Poly b3 = psub(F, sred(C, pmul(F, c, psub(F, e1.a, x3))), e1.b);
  out.a = x3;
  out.b = sred(C, b3);
  return out;
}

static SEndo endo_smul(SchoofCtx &C, const SEndo &e, u64 k) {
  SEndo res;
  res.inf = true;
  SEndo acc = e;
  while (k && !C.failed) {
    if (k & 1) res = endo_add(C, res, acc);
    k >>= 1;
    if (k) acc = endo_add(C, acc, acc);
  }
  return res;
}

static bool sendo_eq(const SEndo &a, const SEndo &b) {
  if (a.inf || b.inf) return a.inf && b.inf;
  return peq(a.a, b.a) && peq(a.b, b.b);
}

// t mod l via pi^2 + [p mod l] = [t]*pi in F_p[x]/psi_l
// (schoofs.rs:76-138); returns -1 only on internal error
static int64_t schoof_trace_odd(const FieldCtx &F, const Fe &Am,
                                const Fe &Bm, u32 ell) {
  std::vector<Poly> f = division_polys(F, Am, Bm, (int)ell);
  Poly modulus = f[ell];
  Poly Fc = {Bm, Am, fe_small(F, 0), F.one_m};
  ptrim(Fc);
  Fe pm1_half;  // (p - 1) / 2
  {
    Fe one;
    std::memset(one.v, 0, sizeof(Fe));
    one.v[0] = 1;
    Fe pm1;
    fe_sub_raw(pm1, F.p, one);
    for (int i = 0; i < NL; ++i) {
      pm1_half.v[i] = pm1.v[i] >> 1;
      if (i + 1 < NL) pm1_half.v[i] |= pm1.v[i + 1] << 63;
    }
  }
  u64 p_mod_l = 0;  // p mod l via limb folding
  {
    u64 m = 1;  // 2^64 mod l, built incrementally
    for (int i = 0; i < NL; ++i) {
      p_mod_l = (p_mod_l + (u128)(F.p.v[i] % ell) * m % ell) % ell;
      m = (u64)((u128)m * ((((u128)1 << 64) % ell)) % ell);
    }
  }
  for (int guard = 0; guard < 64; ++guard) {
    SchoofCtx C;
    C.F = &F;
    C.modulus = modulus;
    bar_init(F, C.bar, modulus);
    C.Fc = Fc;
    C.failed = false;
    Poly x = {fe_small(F, 0), F.one_m};
    SEndo pi;
    pi.inf = false;
    pi.a = ppowmod(F, x, F.p, C.bar.m);
    pi.b = ppowmod(F, Fc, pm1_half, C.bar.m);
    SEndo pi2;
    pi2.inf = false;
    pi2.a = ppowmod(F, pi.a, F.p, C.bar.m);
    pi2.b = sred(C, pmul(F, pi.b, ppowmod(F, pi.b, F.p, C.bar.m)));
    SEndo identity;
    identity.inf = false;
    identity.a = sred(C, x);
    identity.b = sred(C, Poly{F.one_m});
    SEndo q_endo = endo_smul(C, identity, p_mod_l);
    if (C.failed) { modulus = C.factor; continue; }
    SEndo lhs = endo_add(C, pi2, q_endo);
    if (C.failed) { modulus = C.factor; continue; }
    if (lhs.inf) return 0;
    // baby-step giant-step over the match lhs == [j]pi, j in [1, ell-1]:
    // ~2*sqrt(ell) endo_adds (each one ring inversion) instead of ell
    u32 bs = 1;
    while (bs * bs < ell) ++bs;
    std::vector<SEndo> baby(bs + 1);  // baby[r] = [r]pi
    baby[0].inf = true;
    bool restart = false;
    for (u32 r = 1; r <= bs && !restart; ++r) {
      baby[r] = endo_add(C, baby[r - 1], pi);
      if (C.failed) { modulus = C.factor; restart = true; }
    }
    if (restart) continue;
    SEndo neg_g = baby[bs];  // [-bs]pi
    for (auto &c : neg_g.b) {
      Fe t;
      fe_neg(F, t, c);
      c = t;
    }
    SEndo cur = lhs;  // lhs - [k*bs]pi
    for (u32 k = 0; (u64)k * bs < (u64)ell + bs && !restart; ++k) {
      for (u32 r = 0; r <= bs; ++r) {
        if (sendo_eq(cur, baby[r])) {
          u64 j = (u64)k * bs + r;
          if (j >= 1 && j < ell) return (int64_t)j;
        }
      }
      cur = endo_add(C, cur, neg_g);
      if (C.failed) { modulus = C.factor; restart = true; }
    }
    if (restart) continue;
    return -1;  // unreachable for valid inputs
  }
  return -1;
}

// l = 2 parity: x^3+Ax+B has a root <=> even order <=> t even
// (schoofs.rs:345-366)
static int64_t schoof_trace_two(const FieldCtx &F, const Fe &Am,
                                const Fe &Bm) {
  Poly cubic = {Bm, Am, fe_small(F, 0), F.one_m};
  ptrim(cubic);
  Poly x = {fe_small(F, 0), F.one_m};
  Poly xp = ppowmod(F, x, F.p, cubic);
  Poly g = pgcd(F, cubic, psub(F, xp, x));
  return pdeg(g) != 0 ? 0 : 1;
}

}  // namespace

// ------------------------------------------------------------- C API

extern "C" {

void *ecn_tree_new(const u8 *p_le, const u8 *leaves_le, u64 n,
                   const u8 *maps_blob, u64 maps_len) {
  Tree *T = new Tree();
  ctx_init(T->F, p_le);
  T->n = n;
  // leaves (canonical -> montgomery)
  int logn = ilog2_u64(n);
  T->f_layers.resize(logn + 1);
  T->f_layers[0].resize(n);
  for (u64 i = 0; i < n; ++i) {
    Fe c;
    std::memcpy(c.v, leaves_le + 32 * i, 32);
    to_mont(T->F, T->f_layers[0][i], c);
  }
  // maps: per map u32 nlen, coeffs, u32 dlen, coeffs
  const u8 *ptr = maps_blob;
  const u8 *end = maps_blob + maps_len;
  while (ptr < end) {
    RMap rm;
    u32 nlen;
    std::memcpy(&nlen, ptr, 4);
    ptr += 4;
    for (u32 i = 0; i < nlen; ++i) {
      Fe c;
      std::memcpy(c.v, ptr, 32);
      ptr += 32;
      Fe mc;
      to_mont(T->F, mc, c);
      rm.num.push_back(mc);
    }
    u32 dlen;
    std::memcpy(&dlen, ptr, 4);
    ptr += 4;
    for (u32 i = 0; i < dlen; ++i) {
      Fe c;
      std::memcpy(c.v, ptr, 32);
      ptr += 32;
      Fe mc;
      to_mont(T->F, mc, c);
      rm.den.push_back(mc);
    }
    T->maps.push_back(std::move(rm));
  }
  // fill internal domain layers via x-maps (fftree.rs:56-67)
  for (int li = 0; li < logn; ++li) {
    u64 lay = n >> (li + 1);
    T->f_layers[li + 1].resize(lay);
    std::vector<Fe> dens(lay);
    for (u64 i = 0; i < lay; ++i)
      eval_poly(T->F, T->maps[li].den, T->f_layers[li][i], dens[i]);
    fe_batch_inv(T->F, dens.data(), lay);
    for (u64 i = 0; i < lay; ++i) {
      Fe nu;
      eval_poly(T->F, T->maps[li].num, T->f_layers[li][i], nu);
      fe_mul(T->F, T->f_layers[li + 1][i], nu, dens[i]);
    }
  }
  tree_build(*T);
  return T;
}

void ecn_tree_free(void *t) { delete (Tree *)t; }

// helpers to move canonical bytes <-> montgomery vectors
static void load_vec(Tree *T, const u8 *in, u64 cnt, std::vector<Fe> &out) {
  out.resize(cnt);
  for (u64 i = 0; i < cnt; ++i) {
    Fe c;
    std::memcpy(c.v, in + 32 * i, 32);
    to_mont(T->F, out[i], c);
  }
}

static void store_vec(Tree *T, const std::vector<Fe> &in, u8 *out) {
  for (u64 i = 0; i < in.size(); ++i) {
    Fe c;
    from_mont(T->F, c, in[i]);
    std::memcpy(out + 32 * i, c.v, 32);
  }
}

void ecn_enter(void *t, const u8 *coeffs, u64 n, u8 *out) {
  Tree *T = (Tree *)t;
  std::vector<Fe> in, res(n);
  load_vec(T, coeffs, n, in);
  tree_enter(*T, n, in.data(), res.data());
  store_vec(T, res, out);
}

void ecn_exit(void *t, const u8 *evals, u64 n, u8 *out) {
  Tree *T = (Tree *)t;
  std::vector<Fe> in, res(n);
  load_vec(T, evals, n, in);
  tree_exit(*T, n, in.data(), res.data());
  store_vec(T, res, out);
}

void ecn_extend(void *t, const u8 *evals, u64 m, int moiety, u8 *out) {
  Tree *T = (Tree *)t;
  std::vector<Fe> in, res(m);
  load_vec(T, evals, m, in);
  tree_extend(*T, 2 * m, in.data(), res.data(), moiety);
  store_vec(T, res, out);
}

void ecn_mextend(void *t, const u8 *evals, u64 m, int moiety, u8 *out) {
  Tree *T = (Tree *)t;
  std::vector<Fe> in, res(m);
  load_vec(T, evals, m, in);
  tree_mextend(*T, 2 * m, in.data(), res.data(), moiety);
  store_vec(T, res, out);
}

u64 ecn_degree(void *t, const u8 *evals, u64 n) {
  Tree *T = (Tree *)t;
  std::vector<Fe> in;
  load_vec(T, evals, n, in);
  return tree_degree(*T, n, in.data());
}

void ecn_redc(void *t, const u8 *evals, const u8 *a, u64 n, int moiety,
              u8 *out) {
  Tree *T = (Tree *)t;
  std::vector<Fe> in, av, res(n);
  load_vec(T, evals, n, in);
  load_vec(T, a, n, av);
  tree_redc(*T, n, in.data(), av.data(), nullptr, res.data(), moiety);
  store_vec(T, res, out);
}

void ecn_mod(void *t, const u8 *evals, const u8 *a, const u8 *c, u64 n,
             u8 *out) {
  Tree *T = (Tree *)t;
  std::vector<Fe> in, av, cv, res(n);
  load_vec(T, evals, n, in);
  load_vec(T, a, n, av);
  load_vec(T, c, n, cv);
  tree_mod(*T, n, in.data(), av.data(), nullptr, cv.data(), res.data());
  store_vec(T, res, out);
}

void ecn_vanish(void *t, const u8 *pts, u64 n_points, u8 *out) {
  Tree *T = (Tree *)t;
  std::vector<Fe> in, res(2 * n_points);
  load_vec(T, pts, n_points, in);
  tree_vanish(*T, n_points, in.data(), res.data());
  store_vec(T, res, out);
}

// export a table as canonical bytes: which = 0 leaves, 1 xnn, 2 xnn_inv,
// 3 z0_s1, 4 z1_s0, 5 z0i_s1, 6 z1i_s0, 7 z00, 8 z11
u64 ecn_table(void *t, u64 size, int which, u8 *out) {
  Tree *T = (Tree *)t;
  SizeTables &st = T->tab(size);
  const std::vector<Fe> *v = nullptr;
  switch (which) {
    case 0: v = &st.leaves; break;
    case 1: v = &st.xnn; break;
    case 2: v = &st.xnn_inv; break;
    case 3: v = &st.z0_s1; break;
    case 4: v = &st.z1_s0; break;
    case 5: v = &st.z0i_s1; break;
    case 6: v = &st.z1i_s0; break;
    case 7: v = &st.z00; break;
    case 8: v = &st.z11; break;
    default: return 0;
  }
  if (out) store_vec(T, *v, out);
  return v->size();
}

// export selected butterfly matrices for one (size, depth):
// which = 0 dec_s0, 1 dec_s1, 2 rec_s0, 3 rec_s1; each entry is 4
// row-major coefficients. Returns the pair count.
u64 ecn_mats(void *t, u64 size, u64 depth, int which, u8 *out) {
  Tree *T = (Tree *)t;
  SizeTables &st = T->tab(size);
  const std::vector<Fe> *v = nullptr;
  switch (which) {
    case 0: v = &st.dec_s0[depth]; break;
    case 1: v = &st.dec_s1[depth]; break;
    case 2: v = &st.rec_s0[depth]; break;
    case 3: v = &st.rec_s1[depth]; break;
    default: return 0;
  }
  if (out) store_vec(T, *v, out);
  return v->size() / 4;
}

// export a domain layer of the full tree (canonical bytes)
u64 ecn_layer(void *t, u64 layer, u8 *out) {
  Tree *T = (Tree *)t;
  if (layer >= T->f_layers.size()) return 0;
  if (out) store_vec(T, T->f_layers[layer], out);
  return T->f_layers[layer].size();
}

// FIND_CURVE (find_curve.rs:224-246): search for a good curve with
// 2-adicity >= k. Outputs canonical 32-byte a, B, x(gen), y(gen);
// returns the achieved adicity n (0 on failure/timeout).
u64 ecn_find_curve(const u8 *p_le, u64 k, u64 seed, u64 max_iters,
                   u8 *a_out, u8 *bb_out, u8 *x_out, u8 *y_out) {
  FieldCtx F;
  ctx_init(F, p_le);
  Xorshift rng{seed ? seed : 0x9E3779B97F4A7C15ull};
  if (k < 2) k = 2;
  for (u64 it = 0; max_iters == 0 || it < max_iters; ++it) {
    Fe a_c = rng.next_fe(F);
    Fe bb_c = rng.next_fe(F);
    Fe a, bb;
    to_mont(F, a, a_c);
    to_mont(F, bb, bb_c);
    if (fe_is_zero(bb)) continue;
    Fe disc, t;
    fe_sqr(F, disc, a);
    fe_add(F, t, bb, bb);
    fe_add(F, t, t, t);
    fe_sub(F, disc, disc, t);
    if (fe_is_zero(disc)) continue;
    Fe gx;
    int n = fc_cyclic_sylow(F, gx, a, bb);
    if (n >= (int)k) {
      // y = sqrt(x(x² + ax + B))
      Fe yy, u;
      fe_sqr(F, u, gx);
      fe_mul(F, t, a, gx);
      fe_add(F, u, u, t);
      fe_add(F, u, u, bb);
      fe_mul(F, yy, gx, u);
      Fe y;
      if (!fe_sqrt(F, y, yy)) continue;
      Fe c;
      from_mont(F, c, a);
      std::memcpy(a_out, c.v, 32);
      from_mont(F, c, bb);
      std::memcpy(bb_out, c.v, 32);
      from_mont(F, c, gx);
      std::memcpy(x_out, c.v, 32);
      from_mont(F, c, y);
      std::memcpy(y_out, c.v, 32);
      return (u64)n;
    }
  }
  return 0;
}

// batched modular inverse over any (≤256-bit, odd) prime: count 32-byte
// little-endian canonical values, inverted IN PLACE via Montgomery's
// trick (fe_batch_inv). Serves the device pool build's scaled-extend
// tables (ecfft_tpu/ops/schedule.py::build_pool): ~3 native muls per
// element vs a log-depth product-scan of whole-array device muls.
void ecn_batch_inv(const u8 *p_le, const u8 *vals_le, u64 count, u8 *out) {
  FieldCtx F;
  ctx_init(F, p_le);
  std::vector<Fe> v(count);
  for (u64 i = 0; i < count; ++i) {
    Fe c;
    std::memcpy(c.v, vals_le + 32 * i, 32);
    to_mont(F, v[i], c);
  }
  fe_batch_inv(F, v.data(), count);
  for (u64 i = 0; i < count; ++i) {
    Fe c;
    from_mont(F, c, v[i]);
    std::memcpy(out + 32 * i, c.v, 32);
  }
}

// micro-benchmark hook: time raw montgomery muls (for bench baselines)
double ecn_mul_throughput(const u8 *p_le, u64 iters) {
  FieldCtx F;
  ctx_init(F, p_le);
  Fe a = F.one_m, b = F.r2;
  // warm data dependency chain so the loop can't be optimized away
  for (u64 i = 0; i < iters; ++i) fe_mul(F, a, a, b);
  volatile u64 sink = a.v[0];
  (void)sink;
  return (double)a.v[0];
}

// Frobenius trace t mod ell for y^2 = x^3 + Ax + B over F_p
// (schoofs.rs:76-138 / 345-366); returns -1 on internal error. The
// caller (ecfft_tpu/schoof.py) CRT-accumulates across ells in Python.
int64_t ecn_schoof_trace(const u8 *p_le, const u8 *a_le, const u8 *b_le,
                         u32 ell) {
  FieldCtx F;
  ctx_init(F, p_le);
  Fe Ac, Bc, Am, Bm;
  std::memcpy(Ac.v, a_le, 32);
  std::memcpy(Bc.v, b_le, 32);
  to_mont(F, Am, Ac);
  to_mont(F, Bm, Bc);
  if (ell == 2) return schoof_trace_two(F, Am, Bm);
  return schoof_trace_odd(F, Am, Bm, ell);
}

}  // extern "C"

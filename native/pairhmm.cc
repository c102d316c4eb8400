// Native single-thread pair-HMM DP engine.
//
// Two roles:
//  1. Baseline anchor: the reference C++ (CartwrightLab/coati) cannot be
//     compiled in this offline environment (meson/Eigen/Boost absent), so
//     this reimplementation of the same Gotoh recurrence
//     (reference src/lib/align_pair.cc:62-139; written from the algorithm,
//     not copied) compiled -O3 single-thread stands in for the C++ column
//     in benchmarks.
//  2. Host-side fast path: oracle-exact scoring/backpointer fill for small
//     inputs without JAX dispatch overhead, callable via ctypes.
//
// float32 arithmetic and operation order mirror the reference exactly, so
// results are bit-identical to the Python oracle.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kLowest = std::numeric_limits<float>::lowest();

inline float log1p_exp(float x) {
  if (x <= -16.0f) return std::exp(x);
  if (x <= 8.0f) return std::log1p(std::exp(x));
  if (x <= 14.5f) return x + std::exp(-x);
  return x;
}

inline float lse(float a, float b) {
  float mx = a > b ? a : b;
  float y = -std::fabs(a - b);
  return mx + log1p_exp(y);
}

inline float fmax2(float a, float b) { return a > b ? a : b; }

struct GapConsts {
  float ng, gs, go, ge, gek1, gek;
  int k;
};

GapConsts gap_consts(float gap_open, float gap_extend, int k) {
  GapConsts g;
  g.ng = std::log1p(-gap_open);
  g.gs = std::log1p(-gap_extend);
  g.go = std::log(gap_open);
  g.ge = std::log(gap_extend);
  g.gek1 = g.ge * static_cast<float>(k - 1);
  g.gek = g.ge * static_cast<float>(k);
  g.k = k;
  return g;
}

// Packed backpointer codes identical to the device kernels:
// bits 0-1 from-M next state, 2-3 from-D, 4 from-I (0=M, 2=I).
inline uint8_t argmax_mdi(float m, float d, float i) {
  uint8_t code = (d > m) ? 1 : 0;
  float best = fmax2(m, d);
  return (i > best) ? uint8_t(2) : code;
}

template <bool kLog, bool kBp>
float forward_impl(const int32_t* a, int na, const int32_t* b, int nb,
                   const float* table, const GapConsts& g, uint8_t* bp,
                   int* out_state) {
  const int k = g.k;
  const int R = na + k;
  const int C = nb + k;

  // k+1 rolling rows (need rows i-1 and i-k)
  const int H = k + 1;
  std::vector<float> M(static_cast<size_t>(H) * C, kLowest);
  std::vector<float> D(static_cast<size_t>(H) * C, kLowest);
  std::vector<float> I(static_cast<size_t>(H) * C, kLowest);
  auto row = [&](std::vector<float>& X, int i) {
    return X.data() + static_cast<size_t>(i % H) * C;
  };

  const int start = k - 1;
  // row `start` margins
  {
    float* Mr = row(M, start);
    float* Ir = row(I, start);
    Mr[start] = 0.0f;
    for (int j = start + k; j < C; j += k)
      Ir[j] = g.go + g.ge * static_cast<float>(j - 1);
  }

  for (int i = k; i < R; ++i) {
    float* Mi = row(M, i);
    float* Di = row(D, i);
    float* Ii = row(I, i);
    const float* M1 = row(M, i - 1);
    const float* D1 = row(D, i - 1);
    const float* I1 = row(I, i - 1);
    const float* Mk = row(M, i - k);
    const float* Dk = row(D, i - k);
    const float* Ik = row(I, i - k);

    // margin column(s)
    for (int j = 0; j < k; ++j) {
      Mi[j] = kLowest;
      Ii[j] = kLowest;
      Di[j] = kLowest;
    }
    if ((i - start) % k == 0)
      Di[start] = (g.ng + g.go) + g.ge * static_cast<float>(i - 1);

    const float* trow = table + static_cast<size_t>(a[i - k]) * 15;
    for (int j = k; j < C; ++j) {
      const float sub = trow[b[j - k]];
      const float m2m = ((M1[j - 1] + g.ng) + g.ng) + sub;
      const float d2m = (D1[j - 1] + g.gs) + sub;
      const float i2m = ((I1[j - 1] + g.gs) + g.ng) + sub;

      const float m2d = ((Mk[j] + g.ng) + g.go) + g.gek1;
      const float i2d = ((Ik[j] + g.gs) + g.go) + g.gek1;
      const float d2d = Dk[j] + g.gek;

      const float m2i = (Mi[j - k] + g.go) + g.gek1;
      const float i2i = Ii[j - k] + g.gek;

      if (kLog) {
        Mi[j] = lse(lse(m2m, d2m), i2m);
        Di[j] = lse(lse(m2d, d2d), i2d);
        Ii[j] = lse(m2i, i2i);
      } else {
        Mi[j] = fmax2(fmax2(m2m, d2m), i2m);
        Di[j] = fmax2(fmax2(m2d, d2d), i2d);
        Ii[j] = fmax2(m2i, i2i);
      }

      if (kBp) {
        // traceback-form comparisons (align_pair.cc:275-296)
        uint8_t bm = argmax_mdi((M1[j - 1] + g.ng) + g.ng, D1[j - 1] + g.gs,
                                (I1[j - 1] + g.gs) + g.ng);
        uint8_t bd = argmax_mdi((Mk[j] + g.ng) + g.go, Dk[j] + g.ge,
                                (Ik[j] + g.gs) + g.go);
        uint8_t bi = ((Mi[j - k] + g.go) > (Ii[j - k] + g.ge)) ? 0 : 2;
        bp[static_cast<size_t>(i) * C + j] =
            static_cast<uint8_t>(bm | (bd << 2) | (bi << 4));
      }
    }
  }

  // terminal adjustment
  float cm = (row(M, R - 1)[C - 1] + g.ng) + g.ng;
  float ci = (row(I, R - 1)[C - 1] + g.gs) + g.ng;
  float cd = row(D, R - 1)[C - 1] + g.gs;
  float score = fmax2(fmax2(cm, cd), ci);
  if (out_state) *out_state = (ci > fmax2(cm, cd)) ? 2 : ((cd > cm) ? 1 : 0);
  return score;
}

// Lehmer 128-bit-state MCG, bit-compatible with coati_tpu.rng.Lehmer64
// (O'Neill's lehmer64_fast — the reference's fragmites stream): state is
// seeded (state | 1), each draw multiplies by 0xDA942042E4DD58B5 and the
// f24 takes the top 24 bits of the high word.
struct Lehmer128 {
  unsigned __int128 state;
  explicit Lehmer128(uint64_t lo, uint64_t hi) {
    state = ((static_cast<unsigned __int128>(hi) << 64) | lo) | 1;
  }
  inline uint64_t bits() {
    state *= 0xDA942042E4DD58B5ULL;
    return static_cast<uint64_t>(state >> 64);
  }
  inline float f24() {
    return static_cast<float>(bits() >> 40) * (1.0f / 16777216.0f);
  }
};

// xorshift-style 64-bit generator + 24-bit float draw, the same cost
// profile as the reference's fragmites f24 (align_pair.cc:401-458 draws
// one f24 per sampled edge).
struct Rand64 {
  uint64_t s;
  explicit Rand64(uint64_t seed) : s(seed | 1) {}
  inline uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  inline float f24() {
    return static_cast<float>(next() >> 40) * (1.0f / 16777216.0f);
  }
};

}  // namespace

extern "C" {

// Production host sampling path: ONE full Forward (log) fill + n
// stochastic tracebacks drawing from a caller-threaded Lehmer64 f24
// stream (the reference's fragmites generator). The walk mirrors
// align/oracle.py sampleback_mdi operation-for-operation (f32 chains,
// margin copy semantics, 3-way M/D draws and 2-way I draws), so for any
// draw stream it traverses the same distribution; op codes are emitted in
// walk order (-1 padded) in the device sampler's [steps_cap, n] layout.
// rng_state: uint64[2] little-endian halves of the 128-bit Lehmer state,
// updated in place.
void coati_sampleback(const int32_t* a, int na, const int32_t* b, int nb,
                      const float* table, float gap_open, float gap_extend,
                      int k, int n_samples, uint64_t* rng_state,
                      int8_t* ops_out, int steps_cap, float* scores_out) {
  GapConsts g = gap_consts(gap_open, gap_extend, k);
  const int R = na + k;
  const int C = nb + k;
  std::vector<float> M(static_cast<size_t>(R) * C, kLowest);
  std::vector<float> D(static_cast<size_t>(R) * C, kLowest);
  std::vector<float> I(static_cast<size_t>(R) * C, kLowest);
  auto at = [C](std::vector<float>& X, int i, int j) -> float& {
    return X[static_cast<size_t>(i) * C + j];
  };

  const int start = k - 1;
  at(M, start, start) = 0.0f;
  for (int j = start + k; j < C; j += k)
    at(I, start, j) = g.go + g.ge * static_cast<float>(j - 1);
  for (int i = start + k; i < R; i += k)
    at(D, i, start) = (g.ng + g.go) + g.ge * static_cast<float>(i - 1);
  for (int i = k; i < R; ++i) {
    const float* trow = table + static_cast<size_t>(a[i - k]) * 15;
    for (int j = k; j < C; ++j) {
      const float sub = trow[b[j - k]];
      at(M, i, j) = lse(
          lse(((at(M, i - 1, j - 1) + g.ng) + g.ng) + sub,
              (at(D, i - 1, j - 1) + g.gs) + sub),
          ((at(I, i - 1, j - 1) + g.gs) + g.ng) + sub);
      at(D, i, j) = lse(
          lse(((at(M, i - k, j) + g.ng) + g.go) + g.gek1,
              at(D, i - k, j) + g.gek),
          ((at(I, i - k, j) + g.gs) + g.go) + g.gek1);
      at(I, i, j) = lse((at(M, i, j - k) + g.go) + g.gek1,
                        at(I, i, j - k) + g.gek);
    }
  }

  Lehmer128 rng(rng_state[0], rng_state[1]);
  // categorical draws, f32 chains identical to oracle._sample_mdi/_mi
  auto sample3 = [&](float lm, float ld, float li, int* pick) -> float {
    const float m = std::exp(lm), d = std::exp(ld), i2 = std::exp(li);
    const float scale = (m + d) + i2;
    const float p = rng.f24() * scale;
    float chosen;
    if (p < m) {
      *pick = 0;
      chosen = lm;
    } else if (p < (d + m)) {
      *pick = 1;
      chosen = ld;
    } else {
      *pick = 2;
      chosen = li;
    }
    return chosen - std::log(scale);
  };
  auto sample2 = [&](float lm, float li, int* pick) -> float {
    const float m = std::exp(lm), i2 = std::exp(li);
    const float scale = m + i2;
    const float p = rng.f24() * scale;
    float chosen;
    if (p < m) {
      *pick = 0;
      chosen = lm;
    } else {
      *pick = 2;
      chosen = li;
    }
    return chosen - std::log(scale);
  };

  std::fill(ops_out,
            ops_out + static_cast<size_t>(steps_cap) * n_samples,
            int8_t(-1));
  // terminal-adjusted corners written back into the planes, exactly like
  // driver._forward_mdi does for the oracle walk
  at(M, R - 1, C - 1) = (at(M, R - 1, C - 1) + g.ng) + g.ng;
  at(D, R - 1, C - 1) = at(D, R - 1, C - 1) + g.gs;
  at(I, R - 1, C - 1) = (at(I, R - 1, C - 1) + g.gs) + g.ng;
  const float cm = at(M, R - 1, C - 1);
  const float cd = at(D, R - 1, C - 1);
  const float ci = at(I, R - 1, C - 1);
  const float w0 = fmax2(fmax2(cm, cd), ci);
  for (int s = 0; s < n_samples; ++s) {
    int pick;
    float score = sample3(cm - w0, cd - w0, ci - w0, &pick);
    int i = R - 1, j = C - 1, step = 0;
    while ((j > k - 1 || i > k - 1) && step < steps_cap) {
      ops_out[static_cast<size_t>(step) * n_samples + s] =
          static_cast<int8_t>(pick);
      ++step;
      const bool body = (i >= k && j >= k);
      if (pick == 0) {
        const float w = at(M, i, j);
        float mm = kLowest, dm = kLowest, im = kLowest;
        if (body) {
          const float sub =
              table[static_cast<size_t>(a[i - k]) * 15 + b[j - k]];
          mm = ((at(M, i - 1, j - 1) + g.ng) + g.ng) + sub;
          dm = (at(D, i - 1, j - 1) + g.gs) + sub;
          im = ((at(I, i - 1, j - 1) + g.gs) + g.ng) + sub;
        }
        score += sample3(mm - w, dm - w, im - w, &pick);
        --i;
        --j;
      } else if (pick == 1) {
        const float w = at(D, i, j);
        float md = kLowest, dd, id_ = kLowest;
        if (body) {
          md = ((at(M, i - k, j) + g.ng) + g.go) + g.gek1;
          dd = at(D, i - k, j) + g.gek;
          id_ = ((at(I, i - k, j) + g.gs) + g.go) + g.gek1;
        } else {
          dd = at(D, i, j);  // init_margins copy semantics
        }
        score += sample3(md - w, dd - w, id_ - w, &pick);
        i -= k;
      } else {
        const float w = at(I, i, j);
        float mi = kLowest, ii;
        if (body) {
          mi = (at(M, i, j - k) + g.go) + g.gek1;
          ii = at(I, i, j - k) + g.gek;
        } else {
          ii = at(I, i, j);
        }
        score += sample2(mi - w, ii - w, &pick);
        j -= k;
      }
    }
    scores_out[s] = score;
  }
  rng_state[0] = static_cast<uint64_t>(rng.state);
  rng_state[1] = static_cast<uint64_t>(rng.state >> 64);
}

// Reference-equivalent sampling workload anchor (align_marginal.cc:536-594):
// ONE full Forward (log) fill with stored M/D/I planes, then n_samples
// stochastic tracebacks with categorical draws per step. Single thread.
// Returns the sum of sampled path scores (a checksum so the work cannot be
// optimized away); candidate arithmetic matches the device sampler
// (align/sample_device.py) so the walks traverse the same distribution.
double coati_sample_anchor(const int32_t* a, int na, const int32_t* b, int nb,
                           const float* table, float gap_open,
                           float gap_extend, int k, int n_samples,
                           uint64_t seed) {
  GapConsts g = gap_consts(gap_open, gap_extend, k);
  const int R = na + k;
  const int C = nb + k;
  std::vector<float> M(static_cast<size_t>(R) * C, kLowest);
  std::vector<float> D(static_cast<size_t>(R) * C, kLowest);
  std::vector<float> I(static_cast<size_t>(R) * C, kLowest);
  auto at = [C](std::vector<float>& X, int i, int j) -> float& {
    return X[static_cast<size_t>(i) * C + j];
  };

  const int start = k - 1;
  at(M, start, start) = 0.0f;
  for (int j = start + k; j < C; j += k)
    at(I, start, j) = g.go + g.ge * static_cast<float>(j - 1);
  for (int i = start + k; i < R; i += k)
    at(D, i, start) = (g.ng + g.go) + g.ge * static_cast<float>(i - 1);

  for (int i = k; i < R; ++i) {
    const float* trow = table + static_cast<size_t>(a[i - k]) * 15;
    for (int j = k; j < C; ++j) {
      const float sub = trow[b[j - k]];
      const float m2m = ((at(M, i - 1, j - 1) + g.ng) + g.ng) + sub;
      const float d2m = (at(D, i - 1, j - 1) + g.gs) + sub;
      const float i2m = ((at(I, i - 1, j - 1) + g.gs) + g.ng) + sub;
      const float m2d = ((at(M, i - k, j) + g.ng) + g.go) + g.gek1;
      const float i2d = ((at(I, i - k, j) + g.gs) + g.go) + g.gek1;
      const float d2d = at(D, i - k, j) + g.gek;
      const float m2i = (at(M, i, j - k) + g.go) + g.gek1;
      const float i2i = at(I, i, j - k) + g.gek;
      at(M, i, j) = lse(lse(m2m, d2m), i2m);
      at(D, i, j) = lse(lse(m2d, d2d), i2d);
      at(I, i, j) = lse(m2i, i2i);
    }
  }

  // terminal-adjusted corner
  const float cm = (at(M, R - 1, C - 1) + g.ng) + g.ng;
  const float cd = at(D, R - 1, C - 1) + g.gs;
  const float ci = (at(I, R - 1, C - 1) + g.gs) + g.ng;
  const float w0 = fmax2(fmax2(cm, cd), ci);

  Rand64 rand(seed);
  double checksum = 0.0;
  for (int s = 0; s < n_samples; ++s) {
    // terminal-state draw
    float em = std::exp(cm - w0), ed = std::exp(cd - w0),
          ei = std::exp(ci - w0);
    float scale = em + ed + ei;
    float p = rand.f24() * scale;
    int pick = (p < em) ? 0 : ((p < em + ed) ? 1 : 2);
    float score = ((pick == 0) ? cm - w0 : (pick == 1) ? cd - w0 : ci - w0) -
                  std::log(scale);
    int i = R - 1, j = C - 1;
    while (i > k - 1 || j > k - 1) {
      const bool body = (i >= k && j >= k);
      const float sub =
          body ? table[static_cast<size_t>(a[i - k]) * 15 + b[j - k]] : 0.0f;
      const float zero = kLowest;
      float mm = zero, dm = zero, im = zero, md = zero, dd = zero,
            id_ = zero, mi = zero, ii = zero;
      if (body) {
        mm = at(M, i - 1, j - 1) + (g.ng + g.ng) + sub;
        dm = at(D, i - 1, j - 1) + g.gs + sub;
        im = at(I, i - 1, j - 1) + (g.gs + g.ng) + sub;
        md = at(M, i - k, j) + (g.ng + g.go) + g.gek1;
        dd = at(D, i - k, j) + g.gek;
        id_ = at(I, i - k, j) + (g.gs + g.go) + g.gek1;
        mi = at(M, i, j - k) + g.go + g.gek1;
        ii = at(I, i, j - k) + g.gek;
      } else {
        dd = at(D, i, j);
        ii = at(I, i, j);
      }
      const float w = (pick == 0) ? at(M, i, j)
                      : (pick == 1) ? at(D, i, j)
                                    : at(I, i, j);
      const float lm =
          ((pick == 0) ? mm : (pick == 1) ? md : mi) - w;
      const float ld =
          ((pick == 0) ? dm : (pick == 1) ? dd : zero) - w;
      const float li =
          ((pick == 0) ? im : (pick == 1) ? id_ : ii) - w;
      em = std::exp(lm);
      ed = std::exp(ld);
      ei = std::exp(li);
      scale = em + ed + ei;
      p = rand.f24() * scale;
      const int nxt = (p < em) ? 0 : ((p < em + ed) ? 1 : 2);
      score += ((nxt == 0) ? lm : (nxt == 1) ? ld : li) - std::log(scale);
      if (pick == 0) {
        --i;
        --j;
      } else if (pick == 1) {
        i -= k;
      } else {
        j -= k;
      }
      pick = nxt;
    }
    checksum += score;
  }
  return checksum;
}

// Viterbi score only (tropical), O(k * C) memory.
float coati_viterbi_score(const int32_t* a, int na, const int32_t* b, int nb,
                          const float* table, float gap_open, float gap_extend,
                          int k) {
  GapConsts g = gap_consts(gap_open, gap_extend, k);
  return forward_impl<false, false>(a, na, b, nb, table, g, nullptr, nullptr);
}

// Forward (log) total probability score.
float coati_forward_score(const int32_t* a, int na, const int32_t* b, int nb,
                          const float* table, float gap_open, float gap_extend,
                          int k) {
  GapConsts g = gap_consts(gap_open, gap_extend, k);
  return forward_impl<true, false>(a, na, b, nb, table, g, nullptr, nullptr);
}

// Viterbi with packed backpointers; bp must hold (na+k)*(nb+k) bytes.
// Returns the score; *out_state is the terminal argmax (0=M,1=D,2=I).
float coati_viterbi_bp(const int32_t* a, int na, const int32_t* b, int nb,
                       const float* table, float gap_open, float gap_extend,
                       int k, uint8_t* bp, int* out_state) {
  GapConsts g = gap_consts(gap_open, gap_extend, k);
  return forward_impl<false, true>(a, na, b, nb, table, g, bp, out_state);
}

// Build aligned strings from forward-ordered op codes (one pass, all pairs).
//
// ops: [steps, B] int8 column-major over pairs (C order: ops[s*B + p]),
// codes 0=match, 1=delete (consumes k ancestor chars), 2=insert (k des
// chars), -1=padding. Sequences are concatenated with offsets. Outputs are
// written into out0/out1 (caller-allocated, stride out_stride per pair,
// NUL-padded) and out_len receives each alignment's length.
void coati_ops_to_strings(const int8_t* ops, int steps, int n_pairs, int k,
                          const char* a_cat, const int64_t* a_off,
                          const char* b_cat, const int64_t* b_off,
                          char* out0, char* out1, int64_t out_stride,
                          int32_t* out_len) {
  for (int p = 0; p < n_pairs; ++p) {
    const char* a = a_cat + a_off[p];
    const char* b = b_cat + b_off[p];
    char* s0 = out0 + static_cast<int64_t>(p) * out_stride;
    char* s1 = out1 + static_cast<int64_t>(p) * out_stride;
    int64_t ai = 0, bi = 0, w = 0;
    for (int s = 0; s < steps; ++s) {
      const int8_t op = ops[static_cast<int64_t>(s) * n_pairs + p];
      if (op < 0) continue;
      if (op == 0) {
        s0[w] = a[ai++];
        s1[w] = b[bi++];
        ++w;
      } else if (op == 1) {
        for (int t = 0; t < k; ++t) {
          s0[w] = a[ai++];
          s1[w] = '-';
          ++w;
        }
      } else {
        for (int t = 0; t < k; ++t) {
          s0[w] = '-';
          s1[w] = b[bi++];
          ++w;
        }
      }
    }
    out_len[p] = static_cast<int32_t>(w);
  }
}

}  // extern "C"

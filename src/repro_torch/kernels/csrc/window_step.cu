// The main-window loop's own work around K1, for Hopper (sm_90a): the
// window's inputs in the kernels' layout (window_prep_kernel) and the
// commit of its traceback into the pass's state (window_commit_kernel).
//
// Replaces the body of the reference's main-window scan around its fused
// Pallas call, append_main in repro/core/windowing.py:align_pairs: the
// reversed window slices (_slice_rev), the pattern masks and text in the
// kernel layout (repro/kernels/ops.py _pad_to_tile / _to_kernel_layout),
// and the commit (_append_ops and the state's jnp.where updates), which
// XLA fuses on the TPU.  In plain PyTorch these are some 75 small ops a
// window, each a node of a session's CUDA graph, so a graph's launch cost
// host time by its windows; here they are two launches a window.  The
// plain PyTorch versions are window_prep_plain and window_commit_plain in
// repro_torch/kernels/window_step.py.
//
// Bound on the H100: bytes and latency.  A window moves ~0.5 KB a lane at
// W = 64 (the W-base slices read, the masks, text, ops and state written);
// what it costs at a dispatch's 1,024-4,096 lanes is the launch.
//
// The C entry points return a cudaError_t as int; none synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int N_SYMBOLS = 4;          // A, C, G, T; the fifth mask row is
                                      // all ones (sentinel text)
constexpr int SENTINEL_PAT = 255;     // pattern padding: matches nothing
// rows of K1's meta output (genasm_dc.META_*)
constexpr int META_DIST = 0, META_LVL = 1, META_NOPS = 2, META_RD = 3,
              META_RF = 4, META_DFIN = 5;

__device__ __forceinline__ int clamp_start(int pos, int cols, int width) {
  return min(max(pos, 0), cols - width);
}

// One thread a (lane, word w): the 32 pattern positions of word w of the
// window's reversed read slice, reads[b, p + W-1-i] at i in [32w, 32w+32)
// with p = clamp(read_pos[b], 0, read_cols - W), as the masks pm[c][w][b]
// (bit i%32 clear where the base is c; set past W), pm[4][w][b] all ones,
// and the same positions of the reversed reference slice as text[i][b].
// Lanes B .. Bp-1 pad the batch: all-'A' windows (code 0).
__global__ void window_prep_kernel(const uint8_t* __restrict__ reads,
                                   int read_cols,
                                   const uint8_t* __restrict__ refs,
                                   int ref_cols,
                                   const int32_t* __restrict__ read_pos,
                                   const int32_t* __restrict__ ref_pos,
                                   int B, int Bp, int W, int nw,
                                   int32_t* __restrict__ pm,
                                   int32_t* __restrict__ text) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  if (b >= Bp) return;
  const bool real = b < B;
  const uint8_t* pat = nullptr;
  const uint8_t* txt = nullptr;
  if (real) {
    pat = reads + static_cast<int64_t>(b) * read_cols +
          clamp_start(read_pos[b], read_cols, W) + W - 1;
    txt = refs + static_cast<int64_t>(b) * ref_cols +
          clamp_start(ref_pos[b], ref_cols, W) + W - 1;
  }
  uint32_t mask[N_SYMBOLS] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < 32; ++j) {
    const int i = 32 * w + j;
    int code = SENTINEL_PAT;
    if (i < W) {
      code = real ? pat[-i] : 0;
      text[static_cast<int64_t>(i) * Bp + b] = real ? txt[-i] : 0;
    }
    for (int c = 0; c < N_SYMBOLS; ++c)
      mask[c] |= static_cast<uint32_t>(code != c) << j;
  }
  for (int c = 0; c < N_SYMBOLS; ++c)
    pm[(static_cast<int64_t>(c) * nw + w) * Bp + b] =
        static_cast<int32_t>(mask[c]);
  pm[(static_cast<int64_t>(N_SYMBOLS) * nw + w) * Bp + b] = -1;
}

// One thread a lane b < B: K1's outputs of one window (ops (max_ops, Bp),
// meta (8, Bp)) committed into the pass's state, as the reference's scan
// body does.  A lane is active while more than W bases of its read are
// left and it has not failed; an active lane whose window solved
// (dist <= k) appends its ops at its offset into its row of `buf` (the
// last column is the reference's drop slot: nothing is written there) and
// advances; an active lane that did not solve fails.  level[0] takes the
// max of every lane's level count (it starts at INT32_MIN).
__global__ void window_commit_kernel(const int32_t* __restrict__ ops,
                                     const int32_t* __restrict__ meta,
                                     const int32_t* __restrict__ read_len,
                                     int32_t* __restrict__ read_pos,
                                     int32_t* __restrict__ ref_pos,
                                     int32_t* __restrict__ off,
                                     int32_t* __restrict__ dist,
                                     uint8_t* __restrict__ failed,
                                     uint8_t* __restrict__ buf,
                                     int32_t* __restrict__ level, int B,
                                     int Bp, int W, int k, int max_ops,
                                     int buf_cols) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  atomicMax(level, meta[META_LVL * Bp + b]);
  const int d = meta[META_DIST * Bp + b];
  const bool solved = d <= k;
  const bool was_failed = failed[b] != 0;
  const int rp = read_pos[b];
  const bool active = read_len[b] - rp > W && !was_failed;
  if (active && solved) {
    const int n = meta[META_NOPS * Bp + b];
    const int o = off[b];
    const int drop = buf_cols - 1;
    uint8_t* row = buf + static_cast<int64_t>(b) * buf_cols;
    const int last = min(n, max_ops);
    for (int i = 0; i < last && o + i < drop; ++i)
      row[o + i] = static_cast<uint8_t>(ops[static_cast<int64_t>(i) * Bp + b]);
    read_pos[b] = rp + meta[META_RD * Bp + b];
    ref_pos[b] += meta[META_RF * Bp + b];
    off[b] = o + n;
    dist[b] += d - meta[META_DFIN * Bp + b];
  }
  failed[b] = was_failed || (active && !solved);
}

int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

// pm (5, nw, Bp) and text (W, Bp) int32 of one main window, on `stream`.
int genasm_window_prep_launch(const void* reads, const void* refs,
                              const void* read_pos, const void* ref_pos,
                              void* pm, void* text, int read_cols,
                              int ref_cols, int B, int Bp, int W, int nw,
                              void* stream) {
  if (B < 0 || Bp < B || W <= 0 || W > 32 * nw || W > read_cols ||
      W > ref_cols || nw > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Bp == 0) return 0;
  window_prep_kernel<<<dim3(blocks_of(Bp), nw), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(reads), read_cols,
      static_cast<const uint8_t*>(refs), ref_cols,
      static_cast<const int32_t*>(read_pos),
      static_cast<const int32_t*>(ref_pos), B, Bp, W, nw,
      static_cast<int32_t*>(pm), static_cast<int32_t*>(text));
  return static_cast<int>(cudaGetLastError());
}

// One window's commit of K1's ops (max_ops, Bp) and meta (8, Bp) into the
// pass's state and op buffer (B, buf_cols) uint8, on `stream`; `level`
// points at the window's entry of the pass's level counts.
int genasm_window_commit_launch(const void* ops, const void* meta,
                                const void* read_len, void* read_pos,
                                void* ref_pos, void* off, void* dist,
                                void* failed, void* buf, void* level, int B,
                                int Bp, int W, int k, int max_ops,
                                int buf_cols, void* stream) {
  if (B < 0 || Bp < B || max_ops < 0 || buf_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  window_commit_kernel<<<blocks_of(B), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ops), static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(read_len), static_cast<int32_t*>(read_pos),
      static_cast<int32_t*>(ref_pos), static_cast<int32_t*>(off),
      static_cast<int32_t*>(dist), static_cast<uint8_t*>(failed),
      static_cast<uint8_t*>(buf), static_cast<int32_t*>(level), B, Bp, W, k,
      max_ops, buf_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

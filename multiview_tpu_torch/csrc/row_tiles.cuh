// How the BA's row kernels (schur_mv.cu, lm_assembly.cu) split a shard's
// residual rows among the blocks of a persistent launch and stream them
// through shared memory.
//
// The rows of every family are cut into chunks of kChunk rows, family by
// family; block g of G takes a contiguous span of chunks that holds about a
// G-th of all the chunks' bytes (a family's `weight`: the bytes one of its
// rows reads), and walks it in tiles of tile_rows rows, a tile within one
// family. The tiles are staged into shared memory with 16-byte cp.async
// copies and go round a ring of `slots` slots, kPrefetch tiles in flight
// while one is computed; tile i sits in slot i % slots. So after a forward
// walk the span's last min(tiles, slots) tiles are still in their slots, and
// after a reverse walk its first ones: the next walk takes those first
// (`resident`) and reads only the others from device memory.
//
// A family type Fam has the fields n (rows), first_chunk (its first chunk
// among all families') and weight.

#pragma once

#include <cuda_runtime.h>

namespace row_tiles {

constexpr int kChunk = 32;         // rows of the unit the rows are split among the blocks by
constexpr int kPrefetch = 2;       // tiles in flight while one is computed

struct TileRef {
  int f;
  int rows;
  long long row0;
};

__host__ __device__ __forceinline__ int align16(long long b) {
  return static_cast<int>((b + 15) & ~15ll);
}

// The first chunk whose bytes start at or after `at` (of all the chunks'
// bytes, family by family)
template <typename Fam>
__host__ __device__ __forceinline__ long long chunk_at(const Fam* fams, int count, long long at) {
  long long seen = 0;
  for (int fi = 0; fi < count; ++fi) {
    const long long w = fams[fi].weight * kChunk;
    const long long span = (fams[fi].n + kChunk - 1) / kChunk * w;
    if (at < seen + span) return fams[fi].first_chunk + (at - seen + w - 1) / w;
    seen += span;
  }
  return count > 0 ? fams[count - 1].first_chunk + (fams[count - 1].n + kChunk - 1) / kChunk : 0;
}

// The chunk span [c0, c1) of block g of G: as many bytes each; `weight` is
// the bytes of every family's chunks
template <typename Fam>
__host__ __device__ __forceinline__ void block_span(const Fam* fams, int count, long long weight,
                                                    long long g, long long G, long long& c0,
                                                    long long& c1) {
  c0 = chunk_at(fams, count, weight * g / G);
  c1 = chunk_at(fams, count, weight * (g + 1) / G);
}

// The tile at index i of a span (f = -1 past its end), or with i < 0 the
// number of tiles of the span (in .rows)
template <typename Fam>
__host__ __device__ __forceinline__ TileRef locate(const Fam* fams, int count, long long c0,
                                                   long long c1, int tile_rows, int i) {
  int seen = 0;
  for (int fi = 0; fi < count; ++fi) {
    const long long fc0 = fams[fi].first_chunk;
    const long long fc1 = fc0 + (fams[fi].n + kChunk - 1) / kChunk;
    const long long a = c0 > fc0 ? c0 : fc0;
    const long long b = c1 < fc1 ? c1 : fc1;
    if (a >= b) continue;
    const long long r0 = (a - fc0) * kChunk;
    const long long r1 = (b - fc0) * kChunk < fams[fi].n ? (b - fc0) * kChunk : fams[fi].n;
    const int nt = static_cast<int>((r1 - r0 + tile_rows - 1) / tile_rows);
    if (i >= 0 && i < seen + nt) {
      const long long row0 = r0 + static_cast<long long>(i - seen) * tile_rows;
      return {fi, static_cast<int>(r1 - row0 < tile_rows ? r1 - row0 : tile_rows), row0};
    }
    seen += nt;
  }
  return {-1, i < 0 ? seen : 0, 0};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bytes (a multiple of 4) from global to shared by every thread of the block:
// 16-byte copies where both ends allow, 4-byte ones for the rest
__device__ __forceinline__ void copy_async(unsigned char* dst, const unsigned char* src,
                                           long long bytes) {
  long long done = 0;
  if (((reinterpret_cast<unsigned long long>(src) | reinterpret_cast<unsigned long long>(dst)) &
       15ull) == 0) {
    const long long n16 = bytes >> 4;
    for (long long i = threadIdx.x; i < n16; i += blockDim.x) cp_async16(dst + 16 * i, src + 16 * i);
    done = n16 << 4;
  }
  for (long long i = done + 4 * threadIdx.x; i < bytes; i += 4ll * blockDim.x)
    cp_async4(dst + i, src + i);
}

// Walks a span's `tiles` tiles through the ring: step j takes tile j (tile
// tiles - 1 - j with `reverse`); the first `resident` steps find their tile
// in its slot already (left there by the walk before). tile_at(i) gives tile
// i's TileRef, issue(tile, slot) starts its copies, body(tile, slot) is
// called by every thread, between two __syncthreads.
template <typename TileAt, typename Issue, typename Body>
__device__ __forceinline__ void walk(int tiles, bool reverse, int resident, int slots,
                                     int slot_bytes, unsigned char* ring, TileAt tile_at,
                                     Issue issue, Body body) {
  auto tile_of = [&](int j) { return reverse ? tiles - 1 - j : j; };
  auto slot_of = [&](int i) { return ring + static_cast<long long>(i % slots) * slot_bytes; };
  auto start = [&](int j) {
    if (j < tiles && j >= resident) {
      const int i = tile_of(j);
      issue(tile_at(i), slot_of(i));
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) start(j);
  for (int j = 0; j < tiles; ++j) {
    start(j + kPrefetch);
    cp_async_wait<kPrefetch>();
    __syncthreads();
    const int i = tile_of(j);
    body(tile_at(i), slot_of(i));
    __syncthreads();
  }
  cp_async_wait<0>();
}

}  // namespace row_tiles

// The field kernel that the forward (fused_mlp_fwd.cu) and the sigma-only
// (fused_sigma.cu) entry points share, for Hopper (sm_90a): one persistent
// CTA per SM walks tiles of 128 points (64 at H > 256, below); every layer
// product is a wgmma on weight slabs that a producer thread streams into
// shared memory by TMA. Both entry points run the same trunk and alpha head
// code, so on equal points their sigma agrees bit for bit. The backward's
// tile kernel (fused_mlp_bwd.cu) is built from the pieces of the split
// design below: Producer, Ring, layer_product and the PE builder with its
// STASH flag (each PE row to device memory); it writes its own epilogues'
// tiles by stmatrix and sends them on to its stash by TMA stores
// (tma_store_2d); its dW kernel uses the ring's TMA and barriers with the
// MN-major operands of sw128_mn_desc / wgmma_bf16_mn.
//
// What bounds it on an H100: ~1.19 MFLOP per point at lego width (8x256,
// L 10/4) against ~44 bytes of rays in and field out per point, so the
// tensor cores set the pace (989 TFLOP/s bf16, reachable only through
// wgmma), and after them the weights: 1.19 MB of bf16 that no CTA can hold,
// read from L2 once per tile, ~9.3 KB per point at 128-point tiles.
//
// Design at H = 128 and 256 (the register design, field_body_regs), per
// CTA (3 warpgroups, 384 threads):
// - Warpgroup 2: its first thread walks the (tile, product, K-slab)
//   sequence and copies each slab, 64 K-columns x N rows of one packed (N,
//   K) row-major matrix (K-major: no transpose, no repack), into a ring of
//   slots with TMA (one tensor map per product, 128 B swizzle, zeros past
//   K), a full and an empty mbarrier per slot; it runs ahead across product
//   and tile boundaries (every tile reads the same weight sequence). Its
//   warps 1-3 build every tile's PE (pe_warps) a PE slot ahead, behind a
//   full and an empty mbarrier per slot.
// - Warpgroups 0 and 1, the consumers: 64 points each. A product is
//   wgmma.mma_async m64 x N x k16 with the f32 sum in registers and the
//   activations as A in registers too (wgmma_rs): the bf16 pairs an
//   epilogue packs from an accumulator fragment are, in order, the A
//   fragments of the next product's k16 blocks. The skip, layer1 and dir
//   products take their PE columns from shared memory (wgmma_bf16). A slab
//   is released once the next slab's products are issued and its own are
//   done (wait_group 1), the last one before the epilogue.
// - Epilogue in registers: bias, ReLU, bf16 (one cvt.relu a pair), nothing
//   stored and no barrier; the alpha (H -> 1) and rgb (H/2 -> 3) heads are
//   dot products over the accumulator fragment on bf16-rounded inputs,
//   summed across the 4 threads of a row by shuffles. The biases and head
//   weights are resident in shared memory (params_bytes), so a slot holds a
//   slab alone. The warpgroups meet only at the ring and the PE slots.
// - Shared memory: the ring (slots of a 64 x H bf16 slab: 32 KB at H =
//   256), the PE arena (two tiles of [PE(xyz) | PE(dir)] per warpgroup, or
//   one where two leave fewer than 3 ring slots), the resident parameters.
//   Lego forward: 5 slots, 2 PE tiles, 225,316 B; the 24-band, 14-layer
//   edge: 3 slots, 1 PE tile. The plan is made at launch from the card's
//   limit; a descriptor that leaves fewer than 2 slots is refused
//   (cudaErrorInvalidValue), never launched.
//
// The split designs (field_body_split; the backward's tile kernel at every
// width) keep the activations in shared memory instead: each consumer
// warpgroup's product reads A from its activation tile (or, split in N,
// from the tile both share), its epilogue writes the bf16 values back in
// place (after wait_group 0 and a barrier), then fence.proxy.async and a
// barrier come before the next product reads them; a product's last slab
// brings its bias and head weights into the slot (param_bytes), which the
// epilogue holds; each consumer thread builds the next tile's PE two
// columns at a time between this tile's products (a table in shared memory
// says what each column computes).
//
// Wide models (H = 384, 512; the TPU kernel takes any H % 128 == 0). Four
// limits stop the design above there: a product's f32 sum over H columns
// is H/2 registers a thread (the consumers have 232), wgmma's N is at most
// 256, so is a TMA box's row count, and two 128-row activation tiles plus
// ring slots of 64 x H outgrow the 227 KB of shared memory. So at H > 256
// (split_n) the products are chunked in N across the two consumer
// warpgroups: a tile is 64 points, ONE activation tile and one PE tile
// that both warpgroups read whole as A, and warpgroup w computes output
// columns [w H/2, (w + 1) H/2) of every product from its half of each
// slab's rows (m64 n(H/2) k16; the dir product's H/2 columns likewise
// m64 n(H/4)): at most 128 f32 a thread, as at H = 256. A slab of N > 256
// rows comes as two TMA boxes of N/2 rows. The in-place hazard (one
// warpgroup's epilogue overwriting columns of the A tile that the other's
// products still read) is solved by a barrier over both warpgroups (256
// threads) after each product, before either epilogue writes: the sums
// wait in registers. The alpha and rgb heads are dot products over each
// warpgroup's columns, summed across the two through a small exchange
// buffer in one fixed order (warpgroup 0's part, then 1's), so the forward
// and the sigma kernel still agree bit for bit. The cost of the 64-point
// tile: the weights (4.6 MB at 8x512) are read from L2 once per 64 points,
// ~72 KB a point, twice the bytes a point of a 128-point tile. The other
// way, 128-point tiles with each product's output in a spare buffer, needs
// 64 KB more at H = 512 beside 128 KB of activations and a ring of two
// 66 KB slots: it does not fit. (Nor does the register design: 3 H / 4
// registers a thread for a product's sums and its A fragments.)
//
// Wider still (H = 640, 768, 896, 1024; pair_n): one 64-row activation tile
// of H bf16 (80-128 KB) and two ring slots of 64 x H (80-128 KB each)
// outgrow the block, and a warpgroup's H/2 columns pass wgmma's N of 256
// and 128 f32 a thread. So a tile goes to a PAIR of CTAs, a cluster of two
// on neighbouring SMs that walks the tiles by its cluster index: each CTA
// holds the whole 64 x H activation tile and its own PE tile, streams only
// its H/2 rows of every slab (its output columns), and each of its two
// consumer warpgroups computes H/4 of the product's columns (m64 n(H/4)
// k16, n(H/8) for dir: N <= 256 and at most 128 f32 a thread up to 1024).
// After a product's wgmma both CTAs meet at a pair barrier (an mbarrier in
// each CTA that both CTAs' leaders arrive on, release / acquire at cluster
// scope) before any epilogue writes in place: the in-place hazard of the
// split design, now across CTAs. Each epilogue writes its bf16 columns into
// its own tile and, through distributed shared memory (mapa +
// st.shared::cluster), into its peer's; a proxy fence at cluster scope and
// a second pair barrier come before the next product reads. The heads are
// sums over four warpgroups in two CTAs, through the exchange buffer of
// each CTA (every partial written to both), in one fixed order: CTA 0's
// warpgroups 0, 1, then CTA 1's. The forward, sigma and backward kernels
// of one model take the same pair and order, so sigma stays bit for bit
// the forward's channel 3. The slabs are 32 K-columns deep (64 B rows, 64 B
// swizzle in TMA and in the wgmma descriptor, sw64_desc), so that two slots
// fit beside the tile. Per CTA at 8x1024, L 10/4 (PE 64 + 32 columns):
//   activation tile 64 x 1024 bf16             131,072 B
//   PE tile (one; 128 columns)                  16,384 B
//   slot: slab 32 x 512 bf16 + params 6 KB      38,912 B  x 2 = 77,824 B
//   exchange 4 x 4 x 64 f32, 18 barriers, PE table, descriptor  5,380 B
//   forward, sigma (8 KB PE tile): 230,660 / 222,212 B of 232,448.
// The backward's column partials (2 x 4 x (256 + 4) f32 = 8,320 B) would
// miss by 6.5 KB; with one PE tile they live in the PE arena instead,
// which no product reads between the tile's dir product and the next
// tile's PE build. 640 and 768 keep two PE tiles (4 and 3 stages); 896
// and 1024 one (2 stages). The cost: both CTAs build the same PE, and each
// product's output crosses between the SMs once (64 x H/2 bf16 each way).
//
// Numerics (the TPU kernel's): bf16 operands, f32 sums; bias, ReLU and
// sigmoid in f32; an activation is rounded to bf16 only as the next
// product's (or head's) operand. sinf/cosf with full range reduction.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time (no -lcuda)
#include <stdint.h>

#include "fused_mlp_common.cuh"

namespace {

constexpr int WG_THREADS = 128;                // one warpgroup
constexpr int FIELD_THREADS = 3 * WG_THREADS;  // consumers 0, 1; producer 2
constexpr int SLAB_K = 64;                     // bf16 K-columns per 128 B swizzle atom
constexpr int ATOM_BYTES = 64 * 128;           // 64 rows x 64 bf16 of an A tile
constexpr int MAX_STAGES = 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int MAX_BOX_ROWS = 256;  // TMA's limit on a box dimension
constexpr int PE_WARP_THREADS = 3 * 32;  // the register design's PE warps (field_body_regs)

// Whether a width-H model's products are chunked in N across the two
// consumer warpgroups on 64-point tiles (see the top of the file).
__host__ __device__ constexpr bool split_n(int H) { return H > 256; }
// Whether they are chunked across a pair of CTAs as well (the top of the
// file), the CTAs of a cluster, and the K-columns of a ring slab.
__host__ __device__ constexpr bool pair_n(int H) { return H > 512; }
__host__ __device__ constexpr int cluster_ctas(int H) { return pair_n(H) ? 2 : 1; }
__host__ __device__ constexpr int slab_k(int H) { return pair_n(H) ? 32 : SLAB_K; }
// Points per tile.
__host__ __device__ constexpr int tile_rows(int H) { return split_n(H) ? 64 : 128; }
// The wide models' head exchange: per warpgroup that shares a tile (2, or
// 4 in a pair), 64 rows of 4 partial dot products (rgb, alpha).
__host__ __device__ constexpr int xch_bytes(int H) {
  return split_n(H) ? 2 * cluster_ctas(H) * 4 * 64 * (int)sizeof(float) : 0;
}
// Per ring slot after the slab: a product's bias (4 N bytes), then its
// head weights: the alpha head's (2H bytes) after the trunk's last bias at
// alpha_off, the rgb head's (3H bytes) after the dir bias (N = H/2) at
// rgb_off; a multiple of 1 KB, so the slabs stay on the 128 B swizzle's
// 1024 B period.
__host__ __device__ constexpr int param_bytes(int H) {
  return H <= 256 ? 2048 : (6 * H + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int alpha_off(int H) { return H <= 256 ? 1024 : 4 * H; }
__host__ __device__ constexpr int rgb_off(int H) { return H <= 256 ? 1024 : 2 * H; }
// Rows of a TMA box of a slab of N rows: all of them, or half of N > 256.
__host__ __device__ constexpr int slab_box_rows(int N) { return N <= MAX_BOX_ROWS ? N : N / 2; }
// Rows of an N-row product's slab that one CTA of a width-H model streams.
__host__ __device__ constexpr int cta_rows(int H, int N) { return N / cluster_ctas(H); }

struct FieldMaps {
  // one per product, box slab_k(H) x slab_box_rows(cta_rows(H, N)), 128 B
  // swizzle (64 B at 32-column slabs)
  CUtensorMap w[MAX_GEMMS];
};

// Byte offsets into the dynamic shared memory, and the ring's depth.
struct FieldLayout {
  int cluster;  // CTAs a tile is split across
  int stages, slab_bytes, slot_bytes;
  int pe_cols;    // PE columns of a tile: [PE(xyz) | PE(dir)] (sigma: PE(xyz))
  int pe_slots;   // tiles of PE a warpgroup's arena holds: 2 lets it build ahead
  int pe_blocks;  // 64-column atoms of a warpgroup's PE arena
  int act_off, pe_off, extra_off, xch_off, bar_off, tab_off, desc_off, bytes;
};

__host__ __device__ __forceinline__ int round64(int x) { return (x + 63) / 64 * 64; }

// K and N of product g (layer1, trunk 0..L-2, feat, dir) of a width-H model.
__host__ __device__ __forceinline__ int gemm_k(const Desc& d, int g) {
  const int L = d.num_layers;
  if (g == 0) return d.pxp;
  if (g < L) return d.hidden + (((d.skip_mask >> (g - 1)) & 1) ? d.pxp : 0);
  if (g == L) return d.hidden;
  return d.hidden + d.pdp;
}
__host__ __device__ __forceinline__ int gemm_n(const Desc& d, int g) {
  return g == d.num_layers + 1 ? d.hidden / 2 : d.hidden;
}

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits until the mbarrier at shared address a has passed phase `parity`.
__device__ __forceinline__ void mbar_wait_at(uint32_t a, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait_at(smem_u32(bar), parity);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the box at (c0 = K offset, c1 = row 0) of `map` into dst, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// TMA store of the box at (c0 = column, c1 = row) of `map` from src, in
// the issuing thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// The issuing thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// ... and written global memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Four 8 x 8 bf16 matrices between the mma fragment and shared memory: lane
// l gives the address of row l % 8 of matrix l / 8; register i holds row
// lane / 4, columns 2 (lane % 4) and + 1 of matrix i.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Barrier of one warpgroup's 128 threads (ids 1, 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG_THREADS) : "memory");
}

// The consumers' barrier around a tile's products: their own warpgroup's,
// or with SPLIT (split_n) both consumer warpgroups' 256 threads (id 3),
// which share the tile.
template <bool SPLIT>
__device__ __forceinline__ void tile_barrier(int wg) {
  if constexpr (SPLIT)
    asm volatile("bar.sync 3, %0;" ::"n"(2 * WG_THREADS) : "memory");
  else
    wg_barrier(wg);
}

// ---- the pair (H > 512): a cluster of two CTAs that share each tile ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// The cluster's index in the grid, and the clusters of the grid.
__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// The address in CTA `rank`'s shared memory (the cluster's window) of the
// local shared address `addr`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_peer(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// Every thread of both CTAs (the producers' too, or exited): at set-up,
// before a peer's barrier may be arrived on, and before a CTA exits, while
// its peer may still reach into its shared memory.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

// The consumers' barrier across the pair: bar[i] (i = 0 after a product's
// reads, 1 after its epilogue's writes) of each CTA completes when both
// CTAs' leaders have arrived on it, after their own 256 consumer threads
// met (bar.sync 3). Release / acquire at cluster scope carries each CTA's
// writes to the other; two barriers used in turn keep a CTA that runs ahead
// from arriving twice on one phase.
struct Pair {
  uint64_t* bar;      // this CTA's two barriers
  uint32_t peer_bar;  // the peer's, in the cluster's window
  uint32_t phase;     // bit i: the parity bar[i] is at

  __device__ __forceinline__ void sync(int i) {
    asm volatile("bar.sync 3, %0;" ::"n"(2 * WG_THREADS) : "memory");
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.release.cluster.shared::cta.b64 _, [%0];" ::"r"(
                       smem_u32(bar + i))
                   : "memory");
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
                       peer_bar + 8 * i)
                   : "memory");
    }
    const uint32_t a = smem_u32(bar + i), parity = (phase >> i) & 1u;
    uint32_t done;
    do {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    } while (!done);
    phase ^= 1u << i;
  }
  // After this thread's writes to both CTAs' tiles or exchange buffers:
  // they reach the products (the async proxy) and the other threads of
  // both CTAs before either CTA goes on.
  __device__ __forceinline__ void writes_done() {
    asm volatile("fence.proxy.async.shared::cluster;" ::: "memory");
    sync(1);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins accumulator registers in place around the asynchronous products, so
// the compiler neither reads them before wgmma.wait_group nor moves them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128 B swizzled
// layout: rows of 128 B, 8-row groups 1024 B apart (SBO), LBO unused (1).
// Stepping k16 within the atom adds 32 B to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The same in the 64 B swizzled layout of the pair design's 32-column slabs:
// rows of 64 B, 8-row groups 512 B apart (SBO), layout type 2. Stepping k16
// within the row adds 32 B.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}

// D(64 x N, f32) (+)= A(64 x 16) B(16 x N), bf16, A and B K-major in shared
// memory. Fragment of thread t (warp w, lane l) of the warpgroup:
// d[4n + 2i + j] = D[16w + l/4 + 8i][8n + 2(l%4) + j].
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[96], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[48], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// The pair design's shapes (H > 512): a warpgroup's H/4 columns of an
// H-wide product at H = 640 and 896 (n160, n224), its H/8 of the dir
// product (n80, n112).
__device__ __forceinline__ void wgmma_bf16(float (&d)[40], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[56], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "%56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[80], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[112], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111}, "
      "%112, %113, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111])
      : "l"(a), "l"(b), "r"(acc));
}

// D(64 x N, f32) (+)= A(64 x 16) B(16 x N), bf16, A from registers (the
// thread's 4 words of the k16 block: rows r and r + 8 of its fragment,
// columns 2q, 2q + 1 and 2q + 8, 2q + 9, as an accumulator fragment's two
// chunks pack them), B K-major in shared memory; D's fragment as
// wgmma_bf16's. N = 256, 128 and 64: the trunk and the dir products of the
// 256- and 128-wide fields.
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc));
}

// wgmma shared-memory descriptor of an MN-major operand in the 128 B
// swizzled layout, as TMA writes a box of 64 columns (M or N) x rows (K):
// one 128 B row per k, 8-row groups 1024 B apart (SBO), 64-column atoms
// ATOM_BYTES apart (LBO). Stepping k16 adds 2048 B (two groups).
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(ATOM_BYTES >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// D(64 x 256, f32) (+)= A(64 x 16) B(16 x 256), bf16, A and B MN-major in
// shared memory (the transpose immediates set); D's fragment as
// wgmma_bf16's.
__device__ __forceinline__ void wgmma_bf16_mn(float (&d)[128], uint64_t a, uint64_t b,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

// ------------------------------------------------------------ pipeline ----

// 1D bulk copy of `bytes` (a multiple of 16; both ends 16 B aligned) into
// shared memory, completing its bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The consumers' view of the weight ring: slot `stage` of `stages`, and the
// parity its full barrier is at. A slot holds one slab, then param_bytes(H)
// in which the last slab of a product also brings the product's bias and,
// for the alpha and rgb heads, their weights.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* base;  // slot 0
  int slot_bytes, slab_bytes, stages, stage;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  __device__ __forceinline__ const unsigned char* params(int slot) const {
    return base + slot * slot_bytes + slab_bytes;
  }
  // Every consumer warp releases a slot once it is done with it.
  __device__ __forceinline__ void release(int slot, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
};

// Shared address of column c (a multiple of 16) of a tile of 64-column
// atoms: the atom, then 32 B per k16 step inside its 128 B rows.
__device__ __forceinline__ uint32_t col_addr(int c) {
  return (c >> 6) * ATOM_BYTES + (c & 63) * 2;
}

// acc = [A1 | A2] @ W^T over K = k1 + k2, W the product's slabs of SK
// K-columns as they come through the ring. A1 is columns [0, k1) of the
// warpgroup's tile at shared address a1 (k1 a multiple of 64), A2 columns
// [c2, c2 + k2) of the tile at a2 (multiples of 16). The product's 2R
// columns are the slab's rows from byte b_off on (2 SK bytes a row: the
// warpgroup's part of the rows under split_n, else 0). work() runs while
// each slab's products do. Ends with every product done (wait_group 0) and
// returns the product's last slot, still held: its params are the
// epilogue's, which releases it.
template <int SK = SLAB_K, int R, class Work>
__device__ __forceinline__ int layer_product(float (&acc)[R], Ring& ring, uint32_t a1, int k1,
                                             uint32_t a2, int c2, int k2, int lane,
                                             Work&& work, uint32_t b_off = 0) {
  const int K = k1 + k2;
  const uint32_t base = smem_u32(ring.base);
  int prev = -1;
  fence_regs(acc);
  wgmma_fence();
  for (int k0 = 0; k0 < K; k0 += SK) {
    mbar_wait(&ring.full[ring.stage], ring.phase);
    const uint32_t b = base + ring.stage * ring.slot_bytes + b_off;
    // Whole slabs, no branch between the products (a branch makes ptxas
    // fence and serialize them). Past K the slab holds TMA's zeros, so any
    // finite A columns add exact zeros there: the last valid k16 step's.
#pragma unroll
    for (int k = 0; k < SK / 16; ++k) {
      const int kw = min(k0 + 16 * k, K - 16);
      const uint32_t a = kw < k1 ? a1 + col_addr(kw) : a2 + col_addr(c2 + kw - k1);
      const uint64_t bd = SK == SLAB_K ? sw128_desc(b + 32 * k) : sw64_desc(b + 32 * k);
      wgmma_bf16(acc, sw128_desc(a), bd, k0 + k);
    }
    wgmma_commit();
    work();
    if (prev >= 0) {
      wgmma_wait<1>();  // the previous slab's products are done: release it
      ring.release(prev, lane);
    }
    prev = ring.stage;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  return prev;
}

// Byte offset of element (row r, column c) in a tile of 64-column, 128 B
// swizzled atoms of 64 rows.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * ATOM_BYTES + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 bf16x2_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The epilogue of an N = 2R-column product: act = relu?(acc + bias) as bf16
// into the warpgroup's tile (rows r and r + 8 of the fragment), bias from
// shared memory. With wa, also the alpha head's partial dot products of
// those rows over this thread's columns, on the bf16-rounded values. In
// groups of 8 column chunks: the compiler barrier between groups keeps it
// from hoisting every load ahead, which costs the registers that hold
// loop-invariant addresses (their spills go to L2, round trips of ~1 us).
//
// PAIR (pair_n): act is the tile's base and c0 the warpgroup's first column
// in it; each value also goes to the peer CTA's tile, at `peer` (the tile's
// base in the cluster's window).
template <int R, bool PAIR = false>
__device__ __forceinline__ void epilogue(const float (&acc)[R], const float* bias, bool relu,
                                         unsigned char* act, int r, int q, const bf16* wa,
                                         float& s0, float& s1, int c0 = 0, uint32_t peer = 0) {
  constexpr int CHUNKS = R / 4;  // of 8 columns
#pragma unroll
  for (int n0 = 0; n0 < CHUNKS; n0 += 8) {
#pragma unroll
    for (int n = n0; n < n0 + 8 && n < CHUNKS; ++n) {
      const int col = 8 * n + 2 * q;
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
      float v[4] = {acc[4 * n] + b.x, acc[4 * n + 1] + b.y, acc[4 * n + 2] + b.x,
                    acc[4 * n + 3] + b.y};
      if (relu) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
      }
      const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
      *reinterpret_cast<uint32_t*>(act + swz(r, c0 + col)) = lo;
      *reinterpret_cast<uint32_t*>(act + swz(r + 8, c0 + col)) = hi;
      if constexpr (PAIR) {
        st_peer(peer + swz(r, c0 + col), lo);
        st_peer(peer + swz(r + 8, c0 + col), hi);
      }
      if (wa != nullptr) {
        const float2 w = bf16x2_at(wa + col);
        const float2 x0 = bf16x2_at(reinterpret_cast<const bf16*>(&lo));
        const float2 x1 = bf16x2_at(reinterpret_cast<const bf16*>(&hi));
        s0 += x0.x * w.x + x0.y * w.y;
        s1 += x1.x * w.x + x1.y * w.y;
      }
    }
    asm volatile("" ::: "memory");
  }
}

__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// What PE column c of a tile computes, resolved once per CTA: PE(p) is
// [p if included, sin(p_c f_l) for c, l, cos(p_c f_l) for c, l, zeros past
// the encoding], as the plain version's. code = kind | component << 2 |
// dir << 4, kind 0 zero (padding), 1 the coordinate, 2 sin, 3 cos of
// coordinate * f.
struct PeCol {
  float f;
  int code;
};

__device__ __forceinline__ PeCol pe_col(const Desc& d, int c, bool fwd) {
  const bool dir = c >= d.pxp;
  int j = dir ? c - d.pxp : c;
  const int L = dir ? d.ld : d.lx, inc = dir ? d.inc_d : d.inc_x;
  if (dir && (!fwd || j >= d.pdp)) return {0.f, 0};
  const int part = dir ? 16 : 0;
  if (inc) {
    if (j < 3) return {0.f, 1 | j << 2 | part};
    j -= 3;
  }
  const int kind = j < 3 * L ? 2 : 3;
  if (kind == 3) j -= 3 * L;
  if (j >= 3 * L) return {0.f, 0};
  return {(dir ? d.fd : d.fx)[j % L], kind | (j / L) << 2 | part};
}

// Builds a warpgroup's PE tile of 64 rows (global rows row0..row0 + 63):
// the columns of `tab`, [PE(xyz) | PE(dir)] (PE(dir) only for the forward),
// from column `base` of the warpgroup's PE arena on, in the swizzled layout.
// Thread t owns row t % 64, whose point start() reads once, and the
// 8-column chunks t / 64, t / 64 + STRIDE, ... (STRIDE 2: the 128 threads
// of one warpgroup build its tile; 4: the 256 of both build the tile they
// share under split_n); step() computes the next two
// columns and stores a chunk (16 B) once it is whole, so that a tile's PE
// can be built a little at a time between the products of the tile before
// without holding up their issue. Rows past n_pts read the point 0.
// Forward: the point is o + d*z of its ray, unfused as in the plain
// version; sigma: `src` holds the (N, 3) points. STASH (the backward): each
// whole chunk also goes to the point's row of a row-major array of the
// tab's columns (stash_row), tail rows included.
template <bool FWD, bool STASH = false, int STRIDE = 2>
struct PeBuild {
  float x0, x1, x2, v0, v1, v2;
  uint32_t w0, w1, w2, w3;  // the chunk's column pairs so far, newest last
  int chunk, pair, base;
  bf16* row_out;  // STASH: the point's row

  __device__ __forceinline__ void stash_row(bf16* rows, int width, long long row0, int t) {
    row_out = rows + (row0 + (t & 63)) * width;
  }

  __device__ __forceinline__ void start(const float* __restrict__ src,
                                        const float* __restrict__ dirs,
                                        const float* __restrict__ z, long long n_pts,
                                        int samples, long long row0, int base_col, int t) {
    const long long g = row0 + (t & 63);
    x0 = x1 = x2 = v0 = v1 = v2 = 0.f;
    if (g < n_pts) {
      if constexpr (FWD) {
        const long long ray = g / samples;
        const float zt = z[g];
        v0 = dirs[3 * ray];
        v1 = dirs[3 * ray + 1];
        v2 = dirs[3 * ray + 2];
        x0 = __fadd_rn(src[3 * ray], __fmul_rn(v0, zt));
        x1 = __fadd_rn(src[3 * ray + 1], __fmul_rn(v1, zt));
        x2 = __fadd_rn(src[3 * ray + 2], __fmul_rn(v2, zt));
      } else {
        x0 = src[3 * g];
        x1 = src[3 * g + 1];
        x2 = src[3 * g + 2];
      }
    }
    chunk = t >> 6;
    pair = 0;
    base = base_col;
  }

  // A warp's lanes share their chunk, so the branches below are uniform.
  __device__ __forceinline__ void step(const PeCol* tab, int chunks, unsigned char* pe, int t) {
    if (chunk >= chunks) return;
    float e[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const PeCol col = tab[8 * chunk + 2 * pair + h];
      const int comp = (col.code >> 2) & 3, kind = col.code & 3;
      const bool dir = col.code & 16;
      const float a = comp == 0 ? (dir ? v0 : x0)
                                : (comp == 1 ? (dir ? v1 : x1) : (dir ? v2 : x2));
      if (kind == 2)
        e[h] = sinf(a * col.f);
      else if (kind == 3)
        e[h] = cosf(a * col.f);
      else
        e[h] = kind == 1 ? a : 0.f;
    }
    w0 = w1;
    w1 = w2;
    w2 = w3;
    w3 = pack_bf16(e[0], e[1]);
    if (++pair == 4) {
      *reinterpret_cast<uint4*>(pe + swz(t & 63, base + 8 * chunk)) = make_uint4(w0, w1, w2, w3);
      if constexpr (STASH)
        *reinterpret_cast<uint4*>(row_out + 8 * chunk) = make_uint4(w0, w1, w2, w3);
      pair = 0;
      chunk += STRIDE;
    }
  }

  __device__ __forceinline__ void finish(const PeCol* tab, int chunks, unsigned char* pe, int t) {
    while (chunk < chunks) step(tab, chunks, pe, t);
  }
};

// The producer's side of the ring: one thread streams a product's K-slabs
// of SK columns, the boxes (k0, row) of `map` for k0 < K, `rows` rows of
// the product's N (all of them, or this CTA's N/2 in a pair; as two boxes
// of rows/2 for rows > 256), into the slots in turn; the last slab also
// brings `bias` (N floats, when given) and `head_bytes` of `head` (when
// given, at byte head_at) into the slot's params.
struct Producer {
  int stage;
  uint32_t phase;
  template <int SK>
  __device__ __forceinline__ void product(unsigned char* smem, const FieldLayout& lay,
                                          uint64_t* full, uint64_t* empty,
                                          const CUtensorMap* map, int row, int K, int N,
                                          int rows, const float* bias, const bf16* head,
                                          uint32_t head_bytes, int head_at) {
    for (int k0 = 0; k0 < K; k0 += SK) {
      const bool last = k0 + SK >= K;
      uint32_t bytes = SK * rows * sizeof(bf16);
      if (last)
        bytes += (bias != nullptr ? N * sizeof(float) : 0) + (head != nullptr ? head_bytes : 0);
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_arrive_expect_tx(&full[stage], bytes);
      unsigned char* slot = smem + stage * lay.slot_bytes;
      const int box = slab_box_rows(rows);
      for (int b = 0; b < rows; b += box)  // 2 SK bytes a slab row
        tma_load_2d(slot + b * SK * (int)sizeof(bf16), map, k0, row + b, &full[stage]);
      if (last) {
        unsigned char* params = slot + lay.slab_bytes;
        if (bias != nullptr) bulk_load(params, bias, N * sizeof(float), &full[stage]);
        if (head != nullptr) bulk_load(params + head_at, head, head_bytes, &full[stage]);
      }
      if (++stage == lay.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
};

// The head weights product g of a field brings with its last slab, their
// bytes and their offset in the slot's params: the alpha head with the
// trunk's last product, the rgb head with dir.
__device__ __forceinline__ const bf16* product_head(const Desc& d, const bf16* W, int g,
                                                    uint32_t* bytes, int* at) {
  const int L = d.num_layers;
  *bytes = g == L - 1 ? 2 * d.hidden : 3 * d.hidden;
  *at = g == L - 1 ? alpha_off(d.hidden) : rgb_off(d.hidden);
  return g == L - 1 ? W + d.wa_off : (g == L + 1 ? W + d.wr_off : nullptr);
}

// The resident parameters of the register design (H <= 256, forward and
// sigma; field_body_regs), at lay.extra_off: the packed f32 biases whole
// (every product's at b_off, the alpha head's at ba_off, the rgb head's at
// br_off), then the alpha head's H and the rgb head's 3 H/2 bf16 weights.
__host__ __device__ __forceinline__ int bias_bytes(const Desc& d) {
  return (4 * (d.br_off + 3) + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int params_bytes(const Desc& d) {
  return bias_bytes(d) + (5 * d.hidden + 15) / 16 * 16;
}

// Shared-memory set-up of a kernel on the ring: the descriptor's copy (its
// arrays are indexed at run time), the ring's barriers (and a pair's two
// after them, Pair), the PE column table (pe_col with `fwd`). Ends with a
// block barrier, or a cluster barrier in a pair. Given the packed weights
// and biases (the register design), also the PE slots' full and empty
// barriers after the ring's, and the resident parameters (params_bytes).
__device__ __forceinline__ Desc& field_setup(unsigned char* smem, const Desc& desc,
                                             const FieldLayout& lay, bool fwd,
                                             const bf16* W = nullptr, const float* B = nullptr) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + MAX_STAGES;
  PeCol* tab = reinterpret_cast<PeCol*>(smem + lay.tab_off);
  Desc& d = *reinterpret_cast<Desc*>(smem + lay.desc_off);
  if (threadIdx.x == 0) {
    d = desc;
    for (int s = 0; s < lay.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS / 32);  // every consumer warp releases
    }
    if (lay.cluster > 1)  // the pair's barriers: both CTAs' leaders arrive
      for (int i = 0; i < 2; ++i) mbar_init(&empty[MAX_STAGES + i], lay.cluster);
    if (W != nullptr)  // PE slots: every PE warp thread fills, every consumer warp empties
      for (int s = 0; s < 2; ++s) {
        mbar_init(&empty[MAX_STAGES + s], PE_WARP_THREADS);
        mbar_init(&empty[MAX_STAGES + 2 + s], 2 * WG_THREADS / 32);
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int c = threadIdx.x; c < lay.pe_cols; c += FIELD_THREADS) tab[c] = pe_col(d, c, fwd);
  if (W != nullptr) {
    float* pb = reinterpret_cast<float*>(smem + lay.extra_off);
    bf16* ph = reinterpret_cast<bf16*>(smem + lay.extra_off + bias_bytes(d));
    for (int i = threadIdx.x; i < d.br_off + 3; i += FIELD_THREADS) pb[i] = B[i];
    for (int i = threadIdx.x; i < d.hidden; i += FIELD_THREADS) ph[i] = W[d.wa_off + i];
    for (int i = threadIdx.x; i < 3 * d.hidden / 2; i += FIELD_THREADS)
      ph[d.hidden + i] = W[d.wr_off + i];
  }
  if (lay.cluster > 1)
    cluster_sync_all();  // the peer's barriers are ready before any arrive on them
  else
    __syncthreads();
  return d;
}

// The consumers' synchronisation on a tile of a width-H model: the barrier
// after a product (every warp has read the tile) and after its epilogue
// (its writes are there for the next product): the warpgroup's own, both
// warpgroups' (split_n), or both CTAs' of a pair (pair_n, through Pair);
// and the heads' exchange (split_n): warpgroup u's part of a head's dot
// products of rows r, r + 8 goes to channel c of xch (in a pair, of both
// CTAs' xch), and sum() adds the parts in the order of u once exchanged()
// has passed.
template <int H>
struct TileSync {
  static constexpr bool SPLIT = split_n(H), PAIR = pair_n(H);
  Pair pair;
  float* xch;
  uint32_t xch_peer;  // the peer's xch in the cluster's window
  int wg, u;

  __device__ __forceinline__ void products_done() {
    if constexpr (PAIR)
      pair.sync(0);
    else
      tile_barrier<SPLIT>(wg);
  }
  __device__ __forceinline__ void writes_done() {
    if constexpr (PAIR) {
      pair.writes_done();
    } else {
      fence_proxy_async();
      tile_barrier<SPLIT>(wg);
    }
  }
  __device__ __forceinline__ void exchanged() {
    if constexpr (PAIR)
      pair.writes_done();
    else
      tile_barrier<SPLIT>(wg);
  }
  __device__ __forceinline__ void put(int c, int r, float p0, float p1) {
    const int i = (u * 4 + c) * 64 + r;
    xch[i] = p0;
    xch[i + 8] = p1;
    if constexpr (PAIR) {
      st_peer(xch_peer + 4 * i, __float_as_uint(p0));
      st_peer(xch_peer + 4 * (i + 8), __float_as_uint(p1));
    }
  }
  __device__ __forceinline__ float sum(int c, int row) const {
    float v = xch[c * 64 + row] + xch[(4 + c) * 64 + row];
    if constexpr (PAIR) v = v + xch[(8 + c) * 64 + row] + xch[(12 + c) * 64 + row];
    return v;
  }
};

// A consumer warpgroup's TileSync: the pair's barriers follow the ring's.
template <int H>
__device__ __forceinline__ TileSync<H> tile_sync(unsigned char* smem, const FieldLayout& lay,
                                                 int rank, int wg) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off) + 2 * MAX_STAGES;
  float* xch = reinterpret_cast<float*>(smem + lay.xch_off);
  const uint32_t peer = rank ^ 1;
  const bool pair = pair_n(H);
  return {{bars, pair ? peer_addr(smem_u32(bars), peer) : 0u, 0u},
          xch, pair ? peer_addr(smem_u32(xch), peer) : 0u, wg, rank * 2 + wg};
}

// ---- the register design (H = 128, 256: the forward and sigma; the top
// of the file). The warpgroups meet nowhere but at the ring and the PE
// slots, so that one's epilogue can run while the other's products do
// (holding warpgroup 1 a product behind, or having the two take turns on
// the tensor cores by halves of a product, measured no faster: PERF.md's
// findings).

// Stores bf16(v) at (row r, column c) of a swizzled PE tile.
__device__ __forceinline__ void st_pe(unsigned char* pe, int r, int c, float v) {
  *reinterpret_cast<bf16*>(pe + swz(r, c)) = __float2bfloat16_rn(v);
}

// Component c (0, 1, 2) of N rows' encodings (PE(xyz) or PE(dir)) of
// coordinates v (that component of each row's point or direction) into
// columns [c0, c0 + width) of rows r of the swizzled PE tiles at pe, as
// pe_col lays them out: the raw coordinate at column c, sin(v f_l) at s0 +
// c L + l and cos(v f_l) at s0 + 3 L + c L + l for each band l, both from
// one range reduction (sincosf gives sinf's and cosf's bits); component 0
// also writes the zero padding past s0 + 6 L. The N rows' arguments are
// independent, so their sincosf chains overlap.
template <int N>
__device__ __forceinline__ void pe_component(unsigned char* const (&pe)[N], const int (&r)[N],
                                             int c0, const float (&v)[N], int c, const float* f,
                                             int L, int inc, int width) {
  const int s0 = inc ? 3 : 0;
  if (inc) {
#pragma unroll
    for (int i = 0; i < N; ++i) st_pe(pe[i], r[i], c0 + c, v[i]);
  }
  if (c == 0)
    for (int col = s0 + 6 * L; col < width; ++col) {
#pragma unroll
      for (int i = 0; i < N; ++i) st_pe(pe[i], r[i], c0 + col, 0.f);
    }
  const int sc = c0 + s0 + c * L;  // the sin column of band 0
  for (int l = 0; l < L; ++l) {
    const float fl = f[l];
    float sn[N], cs[N];
#pragma unroll
    for (int i = 0; i < N; ++i) sincosf(__fmul_rn(v[i], fl), &sn[i], &cs[i]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      st_pe(pe[i], r[i], sc + l, sn[i]);
      st_pe(pe[i], r[i], sc + 3 * L + l, cs[i]);
    }
  }
}

// The PE warps (warps 1-3 of the producer warpgroup; pt = 0..95): every
// tile's PE, [PE(xyz) | PE(dir)] (sigma: PE(xyz)) of its 128 points into
// each consumer warpgroup's arena (rows 0-63: warpgroup 0's), in PE slot
// after slot once the consumers have emptied it. Warp c takes component c
// of every point (its raw coordinate and its L sin/cos pairs: the same work
// for the three warps), N rows a lane at a time (rows lane + 32 i of the
// tile), so its lanes' branches agree. Rows past n_pts take the point 0.
// Forward: the point is o + d*z of its ray, unfused, as the plain version
// computes it.
template <bool FWD, int N>
__device__ __forceinline__ void pe_warps(unsigned char* smem, const FieldLayout& lay,
                                         const Desc& d, const float* __restrict__ src,
                                         const float* __restrict__ dirs,
                                         const float* __restrict__ z, long long n_pts,
                                         int samples, long long first, long long stride,
                                         long long n_tiles, int pt) {
  static_assert(4 % N == 0, "a tile's 128 rows in passes of 32 N");
  uint64_t* pe_full = reinterpret_cast<uint64_t*>(smem + lay.bar_off) + 2 * MAX_STAGES;
  uint64_t* pe_empty = pe_full + 2;
  const int lane = pt & 31, c = pt >> 5;
  const bool narrow = n_pts <= 0xffffffffLL;  // a point's ray by 32-bit division
  int slot = 0;
  uint32_t phase = 0;
  for (long long tile = first; tile < n_tiles; tile += stride) {
    mbar_wait(&pe_empty[slot], phase ^ 1);
    const int c0 = slot * lay.pe_cols;
    for (int pass = 0; pass < 4 / N; ++pass) {
      unsigned char* pe[N];
      int r[N];
      float x[N], v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int row = 32 * (N * pass + i) + lane;  // of the tile
        pe[i] = smem + lay.pe_off + (row >> 6) * lay.pe_blocks * ATOM_BYTES;
        r[i] = row & 63;
        const long long g = tile * 128 + row;
        x[i] = v[i] = 0.f;
        if (g < n_pts) {
          if constexpr (FWD) {
            const long long ray = narrow ? (long long)((uint32_t)g / (uint32_t)samples)
                                         : g / samples;
            v[i] = dirs[3 * ray + c];
            x[i] = __fadd_rn(src[3 * ray + c], __fmul_rn(v[i], z[g]));
          } else {
            x[i] = src[3 * g + c];
          }
        }
      }
      pe_component(pe, r, c0, x, c, d.fx, d.lx, d.inc_x, d.pxp);
      if constexpr (FWD) pe_component(pe, r, c0 + d.pxp, v, c, d.fd, d.ld, d.inc_d, d.pdp);
    }
    fence_proxy_async();  // the tile's PE, to the consumers' products
    mbar_arrive(&pe_full[slot]);
    if (++slot == lay.pe_slots) {
      slot = 0;
      phase ^= 1;
    }
  }
}

// Keeps registers an asynchronous product reads live until wait_group.
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" ::"r"(a[i]));
}

// The register design's place in the ring: the stage and the parity its
// full barrier is at. The slots' addresses and the ring's depth come from
// the launch's plan (kernel parameters), the barriers' from the shared
// window's 32-bit addresses, so that a consumer thread holds two registers
// of the ring beside its sums and A fragments.
struct RingPos {
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Every consumer warp releases slot `slot` once it is done with it (full:
// the shared address of the ring's first full barrier).
__device__ __forceinline__ void release_at(uint32_t full, int slot, int lane) {
  __syncwarp();
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(full + 8 * (MAX_STAGES + slot))
                 : "memory");
}

// bf16 pairs of relu(lo), relu(hi) in one conversion: the bits of
// pack_bf16(fmaxf(lo, 0.f), fmaxf(hi, 0.f)) at every value but NaN and -0
// (rounding to bf16 keeps a nonzero value's sign; the clamp takes a
// negative result to +0).
__device__ __forceinline__ uint32_t pack_bf16_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// acc = [x | PE] @ W^T, W the product's slabs as they come through the
// ring: x the warpgroup's activations, AS slabs of 64 K-columns as wgmma A
// fragments in registers (a[4 kb .. 4 kb + 3]: k16 block kb, as
// reg_epilogue packs them), then k2 columns (a multiple of 16) of the
// warpgroup's PE tile at shared address pe from column c2 on. Past K the
// last slab holds TMA's zeros, so the last valid k16 step's PE columns add
// exact zeros there (no branch between the products). Each slot is
// released once its products are done; ends with every product done
// (wait_group 0) and every slot released.
template <int AS, int R, int NA>
__device__ __forceinline__ void reg_product(float (&acc)[R], const FieldLayout& lay, RingPos& pos,
                                            const uint32_t (&a)[NA], uint32_t pe, int c2, int k2,
                                            int lane) {
  static_assert(AS * 16 <= NA, "fewer A fragments than the product's x columns");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem), full = base + lay.bar_off;
  int prev = -1;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int k0 = 0; k0 < SLAB_K * AS; k0 += SLAB_K) {
    mbar_wait_at(full + 8 * pos.stage, pos.phase);
    const uint32_t b = base + pos.stage * lay.slot_bytes;
#pragma unroll
    for (int k = 0; k < SLAB_K / 16; ++k)
      wgmma_rs(acc, a[4 * (k0 / 16 + k)], a[4 * (k0 / 16 + k) + 1],
               a[4 * (k0 / 16 + k) + 2], a[4 * (k0 / 16 + k) + 3], sw128_desc(b + 32 * k),
               k0 + k);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();  // the previous slab's products are done: release it
      release_at(full, prev, lane);
    }
    prev = pos.stage;
    pos.advance(lay.stages);
  }
  for (int k0 = 0; k0 < k2; k0 += SLAB_K) {
    mbar_wait_at(full + 8 * pos.stage, pos.phase);
    const uint32_t b = base + pos.stage * lay.slot_bytes;
#pragma unroll
    for (int k = 0; k < SLAB_K / 16; ++k) {
      const int c = c2 + min(k0 + 16 * k, k2 - 16);
      wgmma_bf16(acc, sw128_desc(pe + col_addr(c)), sw128_desc(b + 32 * k), AS + k0 + k);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      release_at(full, prev, lane);
    }
    prev = pos.stage;
    pos.advance(lay.stages);
  }
  wgmma_wait<0>();
  release_at(full, prev, lane);
  fence_regs(acc);
  keep_regs(a);
}

// The epilogue of an N = 2R-column product in registers: act = relu?(acc +
// bias) (bias in shared memory), rounded to bf16 pairs in fragment order,
// which are the next product's A fragments (a[2 n], a[2 n + 1]: chunk n's
// rows r and r + 8). With wa, also the alpha head's partial dot products of
// those rows over this thread's columns, on the bf16-rounded values. In
// groups of 8 chunks, as epilogue().
template <int R>
__device__ __forceinline__ void reg_epilogue(const float (&acc)[R], const float* bias, bool relu,
                                             uint32_t (&a)[R / 2], int q, const bf16* wa,
                                             float& s0, float& s1) {
  constexpr int KB = R / 8;  // k16 blocks of the output
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 2 * kb + h, col = 8 * n + 2 * q;
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
      const float v[4] = {acc[4 * n] + b.x, acc[4 * n + 1] + b.y, acc[4 * n + 2] + b.x,
                          acc[4 * n + 3] + b.y};
      const uint32_t lo = relu ? pack_bf16_relu(v[0], v[1]) : pack_bf16(v[0], v[1]);
      const uint32_t hi = relu ? pack_bf16_relu(v[2], v[3]) : pack_bf16(v[2], v[3]);
      a[2 * n] = lo;
      a[2 * n + 1] = hi;
      if (wa != nullptr) {
        const float2 w = bf16x2_at(wa + col);
        const float2 x0 = bf16x2_at(reinterpret_cast<const bf16*>(&lo));
        const float2 x1 = bf16x2_at(reinterpret_cast<const bf16*>(&hi));
        s0 += x0.x * w.x + x0.y * w.y;
        s1 += x1.x * w.x + x1.y * w.y;
      }
    }
    if (kb % 4 == 3) asm volatile("" ::: "memory");
  }
}

// field_body at H = 128 and 256: the register design (above). Warpgroups 0
// and 1 take rows 0-63 and 64-127 of each 128-point tile; warpgroup 2's
// first thread streams the slabs (Producer, no params), its warps 1-3
// build the PE (pe_warps). The products, their K order, the epilogues'
// and heads' arithmetic are field_body's, so the outputs are its bits.
template <int H, bool FWD>
__device__ __forceinline__ void field_body_regs(const FieldMaps& maps, const Desc& desc,
                                                const FieldLayout& lay,
                                                const float* __restrict__ src,
                                                const float* __restrict__ dirs,
                                                const float* __restrict__ z, long long n_pts,
                                                int samples, const bf16* __restrict__ W,
                                                const float* __restrict__ B,
                                                float* __restrict__ out, int channels_first) {
  constexpr int R = H / 2;   // accumulator floats a thread of an H-wide product
  constexpr int RD = H / 4;  // of the dir product (H/2 wide)
  constexpr int AS = H / 64; // slabs of a product's x columns
  // Registers a thread: the consumers hold a product's sums and its A
  // fragments (3 H / 4 at once); the producer warpgroup's PE warps take the
  // rest of the launch's 168 a thread (sincosf's slow path among them).
  constexpr int CREGS = H == 256 ? 224 : 200;
  constexpr int PREGS = PRODUCER_REGS + 2 * (CONSUMER_REGS - CREGS);
  constexpr int PE_ROWS = 2;  // rows a PE warp lane builds at once (pe_warps)
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* pe_full = full + 2 * MAX_STAGES;
  uint64_t* pe_empty = pe_full + 2;
  const Desc& d = field_setup(smem, desc, lay, FWD, W, B);
  const int tid = threadIdx.x;
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long n_tiles = (n_pts + 127) / 128;
  const int L = d.num_layers;
  const int wg = tid / WG_THREADS;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PREGS));
    if (tid == 2 * WG_THREADS) {
      // Producer: every product's slabs, tile after tile.
      const int n_gemms = FWD ? L + 2 : L;
      Producer prod{0, 0};
      for (long long t = first; t < n_tiles; t += stride)
        for (int g = 0; g < n_gemms; ++g)
          prod.product<SLAB_K>(smem, lay, full, empty, &maps.w[g], 0, gemm_k(d, g), gemm_n(d, g),
                               gemm_n(d, g), nullptr, nullptr, 0, 0);
    } else if (tid >= 2 * WG_THREADS + 32) {
      pe_warps<FWD, PE_ROWS>(smem, lay, d, src, dirs, z, n_pts, samples, first, stride,
                             n_tiles, tid - 2 * WG_THREADS - 32);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
  const int t = tid % WG_THREADS, warp = t / 32, lane = t % 32;
  const int r = warp * 16 + lane / 4, q = lane % 4;  // fragment rows r, r + 8
  const uint32_t pe_a = smem_u32(smem + lay.pe_off + wg * lay.pe_blocks * ATOM_BYTES);
  const float* pb = reinterpret_cast<const float*>(smem + lay.extra_off);  // biases
  const bf16* wa = reinterpret_cast<const bf16*>(smem + lay.extra_off + bias_bytes(d));
  const bf16* wr = wa + H;
  RingPos ring{0, 0};
  int ps = 0;  // the PE slot of this tile, and the parity its full barrier is at
  uint32_t pphase = 0;
  uint32_t a[R / 2];
#pragma unroll
  for (int i = 0; i < R / 2; ++i) a[i] = 0u;

  for (long long tile = first; tile < n_tiles; tile += stride) {
    const long long row0 = tile * 128 + wg * 64;
    // Declared per tile, so the trunk's sums are dead while the dir
    // layer's are live.
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    const int pe_base = ps * lay.pe_cols;  // this tile's first PE column
    const float ba = pb[d.ba_off];
    mbar_wait(&pe_full[ps], pphase);

    // layer1 (no activation), then the ReLU trunk; the alpha head off the
    // trunk's output. The sigma entry point runs exactly this.
    float s0 = 0.f, s1 = 0.f;
    reg_product<0>(acc, lay, ring, a, pe_a, pe_base, d.pxp, lane);
    reg_epilogue(acc, pb + d.b_off[0], false, a, q, L == 1 ? wa : nullptr, s0, s1);
    for (int g = 1; g < L; ++g) {
      const bool skip = (d.skip_mask >> (g - 1)) & 1;
      reg_product<AS>(acc, lay, ring, a, pe_a, pe_base, skip ? d.pxp : 0, lane);
      reg_epilogue(acc, pb + d.b_off[g], true, a, q, g == L - 1 ? wa : nullptr, s0, s1);
    }
    const float alpha0 = quad_sum(s0) + ba, alpha1 = quad_sum(s1) + ba;
    const long long g0 = row0 + r, g1 = g0 + 8;

    if constexpr (!FWD) {
      if (q == 0) {
        if (g0 < n_pts) out[g0] = alpha0;
        if (g1 < n_pts) out[g1] = alpha1;
      }
    } else {
      // sigma, channel 3, now (lane 3 of a quad), so that the sums hold no
      // registers through feat and dir.
      if (q == 3) {
        if (g0 < n_pts) out[channels_first ? 3 * n_pts + g0 : g0 * 4 + 3] = alpha0;
        if (g1 < n_pts) out[channels_first ? 3 * n_pts + g1 : g1 * 4 + 3] = alpha1;
      }
      // feat, then dir on [feat | PE(dir)] -> H/2, then the rgb head in
      // registers.
      float unused0 = 0.f, unused1 = 0.f;
      reg_product<AS>(acc, lay, ring, a, pe_a, 0, 0, lane);
      reg_epilogue(acc, pb + d.b_off[L], true, a, q, nullptr, unused0, unused1);
      float acc_d[RD];
#pragma unroll
      for (int i = 0; i < RD; ++i) acc_d[i] = 0.f;
      reg_product<AS>(acc_d, lay, ring, a, pe_a, pe_base + d.pxp, d.pdp, lane);
      const float* bd = pb + d.b_off[L + 1];
      float c0[3] = {0.f, 0.f, 0.f}, c1[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < RD / 4; ++n) {
        if (n % 8 == 0) asm volatile("" ::: "memory");  // as in epilogue()
        const int col = 8 * n + 2 * q;
        const float2 b = *reinterpret_cast<const float2*>(bd + col);
        const float2 h0 = __bfloat1622float2(__floats2bfloat162_rn(
            fmaxf(acc_d[4 * n] + b.x, 0.f), fmaxf(acc_d[4 * n + 1] + b.y, 0.f)));
        const float2 h1 = __bfloat1622float2(__floats2bfloat162_rn(
            fmaxf(acc_d[4 * n + 2] + b.x, 0.f), fmaxf(acc_d[4 * n + 3] + b.y, 0.f)));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float2 w = bf16x2_at(wr + c * (H / 2) + col);
          c0[c] += h0.x * w.x + h0.y * w.y;
          c1[c] += h1.x * w.x + h1.y * w.y;
        }
      }
      float v0 = 0.f, v1 = 0.f;  // lane q < 3 writes channel q
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x0 = quad_sum(c0[c]), x1 = quad_sum(c1[c]);
        const float br = pb[d.br_off + c];
        const float rgb0 = 1.f / (1.f + expf(-(x0 + br)));
        const float rgb1 = 1.f / (1.f + expf(-(x1 + br)));
        if (q == c) {
          v0 = rgb0;
          v1 = rgb1;
        }
      }
      const long long h0 = row0 + r, h1 = h0 + 8;
      if (q < 3) {
        if (h0 < n_pts) out[channels_first ? (long long)q * n_pts + h0 : h0 * 4 + q] = v0;
        if (h1 < n_pts) out[channels_first ? (long long)q * n_pts + h1 : h1 * 4 + q] = v1;
      }
    }
    // The tile's products are done with its PE slot (wait_group 0).
    __syncwarp();
    if (lane == 0) mbar_arrive(&pe_empty[ps]);
    if (++ps == lay.pe_slots) {
      ps = 0;
      pphase ^= 1;
    }
  }
}

// ------------------------------------------------------------- kernel ----

// field_body above 256 wide: the split designs (split_n, pair_n; the top
// of the file), activation tiles in shared memory that the warpgroups (and
// the CTAs of a pair) share.
template <int H, bool FWD>
__device__ __forceinline__ void field_body_split(const FieldMaps& maps, const Desc& desc,
                                                 const FieldLayout& lay,
                                                 const float* __restrict__ src,
                                                 const float* __restrict__ dirs,
                                                 const float* __restrict__ z, long long n_pts,
                                                 int samples, const bf16* __restrict__ W,
                                                 const float* __restrict__ B,
                                                 float* __restrict__ out, int channels_first) {
  // One 64-point tile that both consumer warpgroups share, each computing
  // NW of an H-wide product's columns and ND of the dir product's. PAIR:
  // the tile is shared by the two CTAs of a cluster as well, NW = H/4.
  static_assert(split_n(H), "H <= 256 takes field_body_regs");
  constexpr bool PAIR = pair_n(H);
  constexpr int C = cluster_ctas(H);
  constexpr int SK = slab_k(H);
  constexpr int ROWS = tile_rows(H);
  constexpr int NW = H / (2 * C);
  constexpr int ND = NW / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + MAX_STAGES;
  const PeCol* tab = reinterpret_cast<const PeCol*>(smem + lay.tab_off);
  const Desc& d = field_setup(smem, desc, lay, FWD);
  const int tid = threadIdx.x;
  // A pair walks the tiles by its cluster's index; its CTAs take the two
  // halves of every product's columns.
  const int rank = PAIR ? (int)cluster_rank() : 0;
  const long long first = PAIR ? cluster_index() : blockIdx.x;
  const long long stride = PAIR ? cluster_count() : gridDim.x;

  const long long n_tiles = (n_pts + ROWS - 1) / ROWS;
  const int L = d.num_layers;
  const int wg = tid / WG_THREADS;

  if (wg == 2) {
    // Producer: one thread streams every product's slabs, tile after tile;
    // a product's last slab also brings its bias and head weights.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == 2 * WG_THREADS) {
      const int n_gemms = FWD ? L + 2 : L;
      Producer prod{0, 0};
      for (long long t = first; t < n_tiles; t += stride) {
        for (int g = 0; g < n_gemms; ++g) {
          uint32_t head_bytes;
          int head_at;
          const bf16* head = product_head(d, W, g, &head_bytes, &head_at);
          const int N = gemm_n(d, g), rows = cta_rows(H, N);
          prod.product<SK>(smem, lay, full, empty, &maps.w[g], rank * rows, gemm_k(d, g), N,
                           rows, B + d.b_off[g], head, head_bytes, head_at);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int t = tid % WG_THREADS, warp = t / 32, lane = t % 32;
    const int r = warp * 16 + lane / 4, q = lane % 4;  // fragment rows r, r + 8
    const int u = rank * 2 + wg;  // the warpgroup's part of the tile's columns
    const int col0 = u * NW, cd0 = u * ND;  // its first columns
    // their rows of this CTA's slabs (2 SK bytes a row)
    const uint32_t b_w = wg * NW * SK * 2, b_d = wg * ND * SK * 2;
    unsigned char* act = smem + lay.act_off;
    unsigned char* pe = smem + lay.pe_off;
    // its output columns: PAIR passes the tile and col0 to the epilogue
    unsigned char* act_w = PAIR ? act : act + col0 / 64 * ATOM_BYTES;
    const int c_w = PAIR ? col0 : 0;
    const uint32_t act_a = smem_u32(act), pe_a = smem_u32(pe);
    const uint32_t act_p = PAIR ? peer_addr(act_a, rank ^ 1) : 0;  // the peer CTA's tile
    Ring ring{full, empty, smem, lay.slot_bytes, lay.slab_bytes, lay.stages, 0, 0};
    TileSync<H> tsync = tile_sync<H>(smem, lay, rank, wg);

    const int chunks = lay.pe_cols / 8;
    const int pt = tid;  // the PE builder's thread: all 256 build the shared tile
    PeBuild<FWD, false, 4> pb;  // the first tile's PE, then each next tile's
    pb.start(src, dirs, z, n_pts, samples, first * ROWS, 0, pt);
    pb.finish(tab, chunks, pe, pt);

    for (long long tile = first; tile < n_tiles; tile += stride) {
      const long long row0 = tile * ROWS;
      const long long next = tile + stride;
      const int pe_base = pb.base;  // this tile's first PE column
      const float ba = B[d.ba_off];
      fence_proxy_async();  // this tile's PE, built by every thread, to the products
      tile_barrier<true>(wg);
      // With two PE slots the next tile's PE is built in the other one,
      // a chunk per slab, while this tile's products run.
      const bool ahead = lay.pe_slots == 2 && next < n_tiles;
      if (ahead)
        pb.start(src, dirs, z, n_pts, samples, next * ROWS, lay.pe_cols - pe_base, pt);
      auto work = [&] {
        if (ahead) pb.step(tab, chunks, pe, pt);
      };

      // layer1 (no activation), then the ReLU trunk; the alpha head off the
      // trunk's output. The sigma entry point runs exactly this. Declared
      // per tile, so the trunk's accumulator is dead while the dir layer's
      // is live; the first product of a layer overwrites it.
      float acc[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
      float s0 = 0.f, s1 = 0.f;
      for (int g = 0; g < L; ++g) {
        const bool skip = g > 0 && ((d.skip_mask >> (g - 1)) & 1);
        const int slot = layer_product<SK>(acc, ring, act_a, g == 0 ? 0 : H, pe_a, pe_base,
                                           g == 0 || skip ? d.pxp : 0, lane, work, b_w);
        tsync.products_done();
        const unsigned char* params = ring.params(slot);
        epilogue<NW / 2, PAIR>(
            acc, reinterpret_cast<const float*>(params) + col0, g > 0, act_w, r, q,
            g == L - 1 ? reinterpret_cast<const bf16*>(params + alpha_off(H)) + col0 : nullptr,
            s0, s1, c_w, act_p);
        ring.release(slot, lane);
        tsync.writes_done();
      }
      // The heads' dot products go through the exchange (TileSync).
      float alpha0 = 0.f, alpha1 = 0.f;
      {
        const float p0 = quad_sum(s0), p1 = quad_sum(s1);
        if (q == 0) tsync.put(3, r, p0, p1);
      }
      const long long g0 = row0 + r, g1 = g0 + 8;
      const bool writer = u == 0;  // who writes a shared tile's output

      if constexpr (!FWD) {
        tsync.exchanged();
        alpha0 = tsync.sum(3, r) + ba;
        alpha1 = tsync.sum(3, r + 8) + ba;
        if (q == 0 && writer) {
          if (g0 < n_pts) out[g0] = alpha0;
          if (g1 < n_pts) out[g1] = alpha1;
        }
      } else {
        float br[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) br[c] = B[d.br_off + c];
        // feat, in place.
        int slot = layer_product<SK>(acc, ring, act_a, H, 0, 0, 0, lane, work, b_w);
        tsync.products_done();
        float unused0 = 0.f, unused1 = 0.f;
        epilogue<NW / 2, PAIR>(acc, reinterpret_cast<const float*>(ring.params(slot)) + col0,
                               true, act_w, r, q, nullptr, unused0, unused1, c_w, act_p);
        ring.release(slot, lane);
        tsync.writes_done();

        // dir on [feat | PE(dir)] -> H/2, then the rgb head in registers.
        float acc_d[ND / 2];
#pragma unroll
        for (int i = 0; i < ND / 2; ++i) acc_d[i] = 0.f;
        slot = layer_product<SK>(acc_d, ring, act_a, H, pe_a, pe_base + d.pxp, d.pdp, lane,
                                 work, b_d);
        tsync.products_done();
        const float* bd = reinterpret_cast<const float*>(ring.params(slot)) + cd0;
        const bf16* wr = reinterpret_cast<const bf16*>(ring.params(slot) + rgb_off(H)) + cd0;
        float c0[3] = {0.f, 0.f, 0.f}, c1[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < ND / 8; ++n) {
          if (n % 8 == 0) asm volatile("" ::: "memory");  // as in epilogue()
          const int col = 8 * n + 2 * q;
          const float2 b = *reinterpret_cast<const float2*>(bd + col);
          const float2 h0 = __bfloat1622float2(__floats2bfloat162_rn(
              fmaxf(acc_d[4 * n] + b.x, 0.f), fmaxf(acc_d[4 * n + 1] + b.y, 0.f)));
          const float2 h1 = __bfloat1622float2(__floats2bfloat162_rn(
              fmaxf(acc_d[4 * n + 2] + b.x, 0.f), fmaxf(acc_d[4 * n + 3] + b.y, 0.f)));
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float2 w = bf16x2_at(wr + c * (H / 2) + col);
            c0[c] += h0.x * w.x + h0.y * w.y;
            c1[c] += h1.x * w.x + h1.y * w.y;
          }
        }
        ring.release(slot, lane);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float p0 = quad_sum(c0[c]), p1 = quad_sum(c1[c]);
          if (q == 0) tsync.put(c, r, p0, p1);
        }
        tsync.exchanged();
        alpha0 = tsync.sum(3, r) + ba;
        alpha1 = tsync.sum(3, r + 8) + ba;
        float v0 = alpha0, v1 = alpha1;  // lane q writes channel q
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float x0 = tsync.sum(c, r), x1 = tsync.sum(c, r + 8);
          const float rgb0 = 1.f / (1.f + expf(-(x0 + br[c])));
          const float rgb1 = 1.f / (1.f + expf(-(x1 + br[c])));
          if (q == c) {
            v0 = rgb0;
            v1 = rgb1;
          }
        }
        if (writer) {
          if (g0 < n_pts) out[channels_first ? (long long)q * n_pts + g0 : g0 * 4 + q] = v0;
          if (g1 < n_pts) out[channels_first ? (long long)q * n_pts + g1 : g1 * 4 + q] = v1;
        }
      }
      // The next tile's PE: what is left of it, or all of it with one slot
      // (this tile's products are done with the slot: a barrier followed
      // the last product that read it).
      if (next < n_tiles) {
        if (!ahead) pb.start(src, dirs, z, n_pts, samples, next * ROWS, 0, pt);
        pb.finish(tab, chunks, pe, pt);
      }
    }
  }
  if constexpr (PAIR) cluster_sync_all();  // no CTA leaves while its peer may reach into it
}

// The body of the forward and the sigma kernel, each a __global__ of its own
// name (fused_mlp_fwd_kernel, fused_sigma_kernel) so that a profile tells
// them apart: the register design at H = 128 and 256 (field_body_regs), the
// split designs above (field_body_split). FWD: rays (src = origins (R, 3),
// dirs (R, 3), z (R, S)) -> [rgb, sigma] per point into out, channels-first
// (4, N) or (N, 4). !FWD: points (src = (N, 3)) -> raw sigma (N,). `maps`,
// `desc` and `lay` are the kernel's parameters.
template <int H, bool FWD>
__device__ __forceinline__ void field_body(const FieldMaps& maps, const Desc& desc,
                                           const FieldLayout& lay, const float* __restrict__ src,
                                           const float* __restrict__ dirs,
                                           const float* __restrict__ z, long long n_pts,
                                           int samples, const bf16* __restrict__ W,
                                           const float* __restrict__ B, float* __restrict__ out,
                                           int channels_first) {
  if constexpr (split_n(H))
    field_body_split<H, FWD>(maps, desc, lay, src, dirs, z, n_pts, samples, W, B, out,
                             channels_first);
  else
    field_body_regs<H, FWD>(maps, desc, lay, src, dirs, z, n_pts, samples, W, B, out,
                            channels_first);
}

// ---------------------------------------------------------------- host ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded; null if absent.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a (rows, K) row-major bf16 matrix at `base`, rows `ld`
// elements apart (0: K), read in boxes of box_k columns (SLAB_K: 128 B
// swizzled; 32: 64 B) x box_rows rows, zeros past K and past the rows.
int encode_slab_map(CUtensorMap* map, const bf16* base, int K, int rows, int box_rows,
                    int box_k = SLAB_K, long long ld = 0) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld > 0 ? ld : K) * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_k, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              box_k == SLAB_K ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The launch checks and device facts every kernel on the ring needs: the
// bulk copies' 16 B aligned sources (the weights' and biases' bases, the
// heads' offsets, every product's bias offset), the SM count and the
// card's shared-memory limit per block; then one tensor map per product
// (the first n_gemms) of the packed weights, boxes of one CTA's rows.
int field_prepare(const Desc& d, const bf16* W, const float* B, int n_gemms, int* sms,
                  int* smem_limit, FieldMaps* maps) {
  if (reinterpret_cast<uintptr_t>(W) % 16 != 0 || reinterpret_cast<uintptr_t>(B) % 16 != 0 ||
      d.wa_off % 8 != 0 || d.wr_off % 8 != 0)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < d.num_layers + 2; ++g)
    if (d.b_off[g] % 4 != 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int H = d.hidden;
  for (int g = 0; g < n_gemms; ++g) {
    const int rc = encode_slab_map(&maps->w[g], W + d.w_off[g], gemm_k(d, g), gemm_n(d, g),
                                   slab_box_rows(cta_rows(H, gemm_n(d, g))), slab_k(H));
    if (rc != 0) return rc;
  }
  return 0;
}

// The shared-memory plan of a launch: two PE slots where they leave the ring
// at least 3 stages, else one; cudaErrorInvalidValue when even one slot
// leaves fewer than 2 stages. `extra_bytes` (a multiple of 16) of the
// kernel's own follow the PE arena at extra_off, then (split_n) the head
// exchange at xch_off; in a pair with one PE slot they lie in the PE arena
// instead where it holds them (the kernel keeps them out of the PE's way:
// extra_off == pe_off). Activation and PE tiles are one per consumer
// warpgroup, or under split_n one that both share. `regs` (the register
// design, field_body_regs): no activation tiles, slots of slabs alone, the
// resident parameters (params_bytes) as the extra bytes, and the PE slots'
// four barriers after the ring's. Mirrored in Python by
// nerfmeshes_tpu_torch/ops/kernels/fused_mlp.py:field_plan, which the
// gate supports_fused reads: keep the two alike.
int field_layout(const Desc& d, bool fwd, int smem_limit, FieldLayout* out,
                 int extra_bytes = 0, bool regs = false) {
  FieldLayout lay = {};
  const int H = d.hidden;
  const bool pair = pair_n(H);
  const int tiles = split_n(H) ? 1 : 2;  // 64-row activation and PE tiles
  lay.cluster = cluster_ctas(H);
  lay.slab_bytes = slab_k(H) * cta_rows(H, H) * (int)sizeof(bf16);
  lay.slot_bytes = lay.slab_bytes + (regs ? 0 : param_bytes(H));
  lay.pe_cols = d.pxp + (fwd ? d.pdp : 0);
  const int act_bytes = regs ? 0 : tiles * (H / 64) * ATOM_BYTES;
  if (regs) extra_bytes = params_bytes(d);
  const int xch = xch_bytes(H);
  // the ring's full and empty barriers, then a pair's two, or the PE slots'
  const int bar_bytes = (2 * MAX_STAGES + (pair ? 2 : 0) + (regs ? 4 : 0)) * (int)sizeof(uint64_t);
  const int tab_bytes = lay.pe_cols * (int)sizeof(PeCol);
  const int aux = xch + bar_bytes + tab_bytes + (int)sizeof(Desc);
  for (lay.pe_slots = 2; lay.pe_slots >= 1; --lay.pe_slots) {
    lay.pe_blocks = round64(lay.pe_slots * lay.pe_cols) / 64;
    const int pe_bytes = tiles * lay.pe_blocks * ATOM_BYTES;
    const bool in_pe = pair && lay.pe_slots == 1 && extra_bytes > 0 && extra_bytes <= pe_bytes;
    const int extra = in_pe ? 0 : extra_bytes;
    const int stages = (smem_limit - act_bytes - pe_bytes - extra - aux) / lay.slot_bytes;
    if (stages < lay.pe_slots + 1) continue;
    lay.stages = stages < MAX_STAGES ? stages : MAX_STAGES;
    lay.act_off = lay.stages * lay.slot_bytes;
    lay.pe_off = lay.act_off + act_bytes;
    lay.extra_off = in_pe ? lay.pe_off : lay.pe_off + pe_bytes;
    lay.xch_off = lay.pe_off + pe_bytes + extra;
    lay.bar_off = lay.xch_off + xch;
    lay.tab_off = lay.bar_off + bar_bytes;
    lay.desc_off = lay.tab_off + tab_bytes;
    lay.bytes = lay.desc_off + (int)sizeof(Desc);
    *out = lay;
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// One persistent launch of a kernel on the ring: a CTA per SM, or with
// `cluster` 2 a pair of CTAs per two SMs (cudaLaunchKernelEx with the
// cluster dimension; as many pairs as the card can hold at once, which
// cudaOccupancyMaxActiveClusters tells at this shared memory), never more
// CTAs than `units` (tiles) take.
template <class Kernel, class... Args>
int ring_launch(Kernel kernel, int cluster, long long units, int sms, int smem_bytes,
                cudaStream_t stream, const Args&... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (cluster == 1) {
    const unsigned grid = (unsigned)(units < sms ? units : sms);
    kernel<<<grid, FIELD_THREADS, smem_bytes, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(FIELD_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3((unsigned)(cluster * (units < clusters ? units : clusters)), 1, 1);
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The parameters of a kernel that runs field_body.
#define FIELD_KERNEL_PARAMS                                                                  \
  const __grid_constant__ FieldMaps maps, const Desc desc, const FieldLayout lay,            \
      const float *__restrict__ src, const float *__restrict__ dirs,                         \
      const float *__restrict__ z, long long n_pts, int samples, const bf16 *__restrict__ W, \
      const float *__restrict__ B, float *__restrict__ out, int channels_first
#define FIELD_KERNEL_ARGS maps, desc, lay, src, dirs, z, n_pts, samples, W, B, out, channels_first

typedef void (*FieldKernel)(FieldMaps, Desc, FieldLayout, const float*, const float*,
                            const float*, long long, int, const bf16*, const float*, float*, int);

// One launch of `kernel` (field_body<H, FWD>) on `stream`: the tensor maps of
// every product it reads, the shared-memory plan, one CTA (or pair) per SM
// (or per tile).
template <int H, bool FWD>
int field_launch(FieldKernel kernel, const Desc& d, const float* src, const float* dirs,
                 const float* z, long long n_pts, int samples, const bf16* W, const float* B,
                 float* out, int channels_first, cudaStream_t stream) {
  int sms = 0, smem_limit = 0;
  FieldMaps maps;
  int rc = field_prepare(d, W, B, FWD ? d.num_layers + 2 : d.num_layers, &sms, &smem_limit,
                         &maps);
  if (rc != 0) return rc;
  FieldLayout lay;
  rc = field_layout(d, FWD, smem_limit, &lay, 0, !split_n(H));
  if (rc != 0) return rc;
  const long long tiles = (n_pts + tile_rows(H) - 1) / tile_rows(H);
  return ring_launch(kernel, cluster_ctas(H), tiles, sms, lay.bytes, stream, maps, d, lay, src,
                     dirs, z, n_pts, samples, W, B, out, channels_first);
}

}  // namespace

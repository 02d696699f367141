// The PTX of thread-block clusters and bulk copies that the persistent scan
// kernels share: K1/K2's (lstm_cluster.cuh, for avsr_tpu/ops/rnn.py's LSTM
// scan cores) and K8's backward (av_align_bwd.cuh, for the scan body of
// avsr_tpu/models/fusion.py:av_align_apply); K5's cross attention, K6's self
// read and K9's backward use its mbarriers and bulk copies.  A CTA
// writes into a peer's shared memory with st.async (mapa addresses), each
// store counting its bytes on the peer's mbarrier; the receiver announces
// the bytes it expects (arrive.expect_tx) and waits for the phase.

#pragma once

#include <stdint.h>

#include "attention_mma.cuh"

namespace {
namespace cluster_ptx {

using mma_attn::smem_addr;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address in CTA `rank`'s shared memory of this CTA's shared address
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// st.async: a store into CTA `rank`'s shared memory (a mapa address) whose
// bytes complete the transaction count of that CTA's mbarrier `bar` (a mapa
// address too); the receiver's wait on the barrier sees the data.
__device__ __forceinline__ void st_async_b32(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(addr), "r"(v), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async_v2f32(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
               "[%0], {%1, %2}, [%3];\n" ::"r"(addr), "f"(a), "f"(b), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}
// makes the barriers' initialisation visible to the cluster's st.async
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival on an mbarrier of this CTA
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// the local arrival of a phase, announcing the bytes the peers will send
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed (acquire at cluster scope:
// the peers' st.async bytes are visible after it)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A bulk copy of `bytes` (a multiple of 16) from this CTA's shared memory
// into CTA `rank`'s (dst a mapa address), counted on that CTA's mbarrier
// `bar` (a mapa address): one instruction where st.async takes one per 16
// bytes.  The source is read asynchronously: it must stay unchanged until
// the receiver has seen the bytes.
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// one bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into this CTA's shared memory, counted on the
// mbarrier `bar`
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// orders this thread's shared-memory writes before the async proxy's reads
// (a bulk copy issued after a barrier that follows it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace cluster_ptx
}  // namespace

// Warp-level staging, dedup and beam merge of one hop lane
// (fused_hop_pq.cu).
//
// Replaces, for the PQ hop: `_merge_into_beam` of
// repro/kernels/fused_hop.py.  One warp handles one query lane in its own
// slice of shared memory and synchronises with __syncwarp alone, so
// several lanes share a block with no block-wide barrier between them.
// Thread t owns candidates j = t, t + 32, ...: it stages them, dedups
// them and scores the fresh ones (the caller writes s.d[l + j] where
// warp_hop_dedup left it finite, between warp_hop_dedup and
// warp_hop_merge).  The semantics are hop_merge.cuh's, which fused_hop_l2
// keeps:
//   1. a candidate is fresh if its id is >= 0, not in the beam and not
//      equal to an earlier candidate (__match_any_sync within each group
//      of 32, a scan of the earlier groups); others score +inf and load
//      nothing; n_fresh is a ballot count;
//   2. stable top-L over [beam | candidates]: entry i goes to slot
//      rank_i = #{k : d_k < d_i} + #{k < i : d_k == d_i} when rank_i < L.
//      (d, index) is a total order, so every slot has exactly one writer,
//      in the order of a stable argsort.  The input beam need not be
//      sorted.  +inf slots become (-1, inf, expanded).  To spare the
//      (L+C)^2 compares of a full rank selection, a bisection on the
//      distances' bit patterns (ballot counts) first finds a threshold
//      that at least L and, unless keys tie, at most max(32, L) finite
//      entries do not exceed; only those survivors are ranked, against
//      each other, and the slots past them are +inf ones.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

struct WarpHop {
    int* ids;        // (l + c,) [beam | candidates]
    float* d;        // (l + c,), 16-byte aligned
    uint8_t* exp;    // (l + c,)
};

__host__ __device__ inline size_t warp_hop_align(size_t n) {
    return (n + 15) & ~(size_t)15;
}

// shared memory of one lane; a multiple of 16 bytes
__host__ __device__ inline size_t warp_hop_bytes(int c, int l) {
    const size_t m = (size_t)l + c;
    return 2 * warp_hop_align(m * 4) + warp_hop_align(m);
}

__device__ __forceinline__ WarpHop warp_hop_layout(unsigned char* base,
                                                   int c, int l) {
    const size_t m = (size_t)l + c;
    WarpHop s;
    s.ids = reinterpret_cast<int*>(base);
    s.d = reinterpret_cast<float*>(base + warp_hop_align(m * 4));
    s.exp = base + 2 * warp_hop_align(m * 4);
    return s;
}

__device__ __forceinline__ void warp_hop_stage(
        const WarpHop& s, const int* __restrict__ cand_ids,
        const int* __restrict__ beam_ids,
        const float* __restrict__ beam_dists,
        const uint8_t* __restrict__ beam_exp, long long lane, int c, int l,
        int t) {
    for (int i = t; i < l; i += 32) {
        s.ids[i] = beam_ids[lane * l + i];
        s.d[i] = beam_dists[lane * l + i];
        s.exp[i] = beam_exp[lane * l + i] ? 1 : 0;
    }
    for (int j = t; j < c; j += 32) {
        s.ids[l + j] = cand_ids[lane * c + j];
        s.d[l + j] = 0.0f;                 // to score, unless dedup says not
        s.exp[l + j] = 0;
    }
    __syncwarp();
}

// Marks the thread's candidates that are not fresh (id < 0, in the beam,
// or equal to an earlier candidate) with d = +inf; fresh ones keep a
// finite d, for the caller to overwrite with their distance.  Returns the
// lane's count of fresh candidates to every thread.
__device__ __forceinline__ int warp_hop_dedup(const WarpHop& s, int c, int l,
                                              int t) {
    constexpr unsigned kAll = 0xffffffffu;
    int n_fresh = 0;
    for (int j0 = 0; j0 < c; j0 += 32) {
        const int j = j0 + t;
        const int id = j < c ? s.ids[l + j] : -1;
        bool dup = (__match_any_sync(kAll, id) & ((1u << t) - 1u)) != 0u;
        // the beam and the earlier groups; a -1 beam slot matches only an
        // id < 0, which is not fresh anyway
        for (int k = 0; k < l + j0; ++k) dup |= s.ids[k] == id;
        const bool fresh = id >= 0 && !dup;
        if (j < c && !fresh) s.d[l + j] = CUDART_INF_F;
        n_fresh += __popc(__ballot_sync(kAll, fresh));
    }
    return n_fresh;
}

// Order-preserving key of a finite distance: unsigned order of keys is
// float order, with -0 folded into +0 so that the two tie as they
// compare.  Distances are never NaN (sums of finite LUT entries, or
// +inf).
__device__ __forceinline__ unsigned warp_hop_key(float d) {
    const unsigned u = __float_as_uint(d == 0.0f ? 0.0f : d);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Writes the lane's new beam and its n_fresh, once every candidate's d
// is its distance or +inf.
__device__ __forceinline__ void warp_hop_merge(const WarpHop& s,
                                               int* __restrict__ out_ids,
                                               float* __restrict__ out_dists,
                                               uint8_t* __restrict__ out_exp,
                                               int* __restrict__ out_fresh,
                                               int n_fresh, long long lane,
                                               int c, int l, int t) {
    constexpr unsigned kAll = 0xffffffffu;
    constexpr int kG = 4;            // groups of 32 keys kept in registers
    __syncwarp();                    // every thread's distances are in

    // 2. only finite entries are ranked: every +inf slot is written the
    //    same (-1, inf, expanded), whichever entry fills it.  A threshold
    //    T that at least L of them do not exceed (or all of them, when
    //    fewer) selects the survivors: the others are larger than every
    //    survivor, so they take no slot and move no survivor's rank.  A
    //    bisection on the keys, with ballot counts, narrows T until at
    //    most max(32, L) entries survive (or the keys left tie).
    const int m = l + c;
    constexpr unsigned kNone = 0xffffffffu;          // not finite, or none
    auto key_at = [&](int i) {
        if (i >= m) return kNone;
        const float d = s.d[i];
        return isfinite(d) ? warp_hop_key(d) : kNone;
    };
    unsigned key[kG];
    unsigned lo = kNone, hi = 0u;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
        key[g] = key_at(32 * g + t);
        lo = min(lo, key[g]);
        if (key[g] != kNone) hi = max(hi, key[g]);
    }
    for (int i = 32 * kG + t; i < m; i += 32) {
        const unsigned k = key_at(i);
        lo = min(lo, k);
        if (k != kNone) hi = max(hi, k);
    }
    lo = __reduce_min_sync(kAll, lo);
    hi = __reduce_max_sync(kAll, hi);               // 0: nothing finite
    auto count_le = [&](unsigned v) {               // #{entries: key <= v}
        int n = 0;
#pragma unroll
        for (int g = 0; g < kG; ++g)
            n += __popc(__ballot_sync(kAll, key[g] <= v));
        for (int i0 = 32 * kG; i0 < m; i0 += 32)
            n += __popc(__ballot_sync(kAll, key_at(i0 + t) <= v));
        return n;
    };
    int n_surv = count_le(hi);                      // the finite entries
    const int enough = l > 32 ? l : 32;
    while (n_surv > enough && lo < hi) {            // warp-uniform
        const unsigned mid = lo + (hi - lo) / 2;
        const int n = count_le(mid);
        if (n >= l) {
            hi = mid;
            n_surv = n;
        } else {
            lo = mid + 1;
        }
    }

    // 3. the survivors (key <= T) move, in order, to the front of the
    //    slice: each group of 32 is read before any of it is written, and
    //    a survivor only moves down, onto entries already read
    int to = 0;
    auto compact = [&](int i0, unsigned ki) {
        const int i = i0 + t;
        const bool keep = ki <= hi;
        const float di = keep ? s.d[i] : 0.0f;
        const int id = keep ? s.ids[i] : 0;
        const uint8_t ex = keep ? s.exp[i] : 0;
        const unsigned votes = __ballot_sync(kAll, keep);
        __syncwarp();
        if (keep) {
            const int at = to + __popc(votes & ((1u << t) - 1u));
            s.d[at] = di;
            s.ids[at] = id;
            s.exp[at] = ex;
        }
        to += __popc(votes);
        __syncwarp();
    };
#pragma unroll
    for (int g = 0; g < kG; ++g)
        if (32 * g < m) compact(32 * g, key[g]);
    for (int i0 = 32 * kG; i0 < m; i0 += 32) compact(i0, key_at(i0 + t));

    // 4. stable rank selection among the survivors: survivor i goes to
    //    slot rank_i = #{k : d_k < d_i} + #{k < i : d_k == d_i} when
    //    rank_i < L; the slots past the last survivor are +inf ones
    for (int i = t; i - t < n_surv; i += 32) {
        const float di = i < n_surv ? s.d[i] : 0.0f;
        int rank = 0;
        for (int k = 0; k < n_surv; ++k) {
            const float dk = s.d[k];
            rank += (dk < di) | ((k < i) & (dk == di));
        }
        if (i < n_surv && rank < l) {
            const long long o = lane * l + rank;
            out_ids[o] = s.ids[i];
            out_dists[o] = di;
            out_exp[o] = s.exp[i];
        }
    }
    for (int slot = n_surv + t; slot < l; slot += 32) {
        const long long o = lane * l + slot;
        out_ids[o] = -1;
        out_dists[o] = CUDART_INF_F;
        out_exp[o] = 1;
    }
    if (t == 0) out_fresh[lane] = n_fresh;
}

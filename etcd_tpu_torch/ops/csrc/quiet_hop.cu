// quiet_hop: the quiescent hop of the batched consensus round
// (etcd_tpu_torch/ops/kernel.py, `_step_body` with quiet=True and
// `route_local`) as hand-written passes, for NVIDIA Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package runs this hop as an XLA
// program. In PyTorch the hop is ~500 small launches, each a strided pass
// over one field of the (G, P, P, F) mailbox or the (G, P, P) progress
// arrays. Here every pass reads a group's state and mailbox once and
// writes them once:
//
//   pred   the quiescence predicate (`_quiet_pred`): one device flag,
//          1 when nothing in the hop can need the sequential phases.
//   msgs   ack_age, the tick (heartbeat fire; the predicate rules out an
//          election draw), the leaders' response pass, each follower's
//          one append-or-heartbeat with the response it stages, NH_SNAP
//          on an escape; writes the conflict scan's indices idx_j.
//   (ring_resolve at TE = E on idx_j: its own launch, unchanged)
//   commit the conflict write and truncation, follower and heartbeat
//          commit, proposal admission, the quorum commit (a sorting
//          network over <= 8 match values in registers), the send plan
//          (appends, their counts, optimistic next/paused, heartbeats,
//          NH_SNAP, NH_VIOLATION); writes prev = next - 1 per target.
//   (ring_resolve at TE = P on prev: its own launch, unchanged)
//   route  the outbox, responses overriding, written straight into the
//          routed inbox (G, P_to, P_from, F), times the drop mask when
//          one is given.
//
// Every output is exactly what the PyTorch hop computes. Inputs are never
// written; the fields the quiet hop never changes (term, vote, state,
// prng, votes, peer_mask) are not touched at all.
//
// Bound: bytes. At G = 100,000 x 7 peers x F = 12 the mailbox is 235 MB
// in and 235 MB out and the state about 176 MB each way, ~0.25 ms at
// 3.35 TB/s a hop. Design: a thread owns one (group, slot) row, and its
// per-target arrays (match, next, ...) live in registers (loops over
// the <= 8 targets, 8 entries and 16 ring slots are unrolled; runtime
// indices select by comparison, so nothing spills to local memory).
// `msgs` and `route` run blocks of whole groups: a block stages its
// groups' mailboxes (contiguous in both the inbox and the routed inbox)
// through shared memory, so device memory sees coalesced reads and
// writes while a thread walks its row's messages. The plan
// (groups_per_block) keeps a block under 48 KB of shared memory and
// about 128 threads (ops/quiet_hop.py::groups_per_block).
//
// Compiled by the host's C++ compiler (no __CUDACC__) the same source
// runs every block on the CPU, one after another, through the same row
// functions and staging: the CPU tests hold that build against the
// PyTorch hop.
//
// C interface (ctypes): `quiet_hop_launch(kernel, words, ptrs)` launches
// one pass on the stream in ptrs and returns cudaGetLastError() (0 on the
// host build); `quiet_hop_layout` reports the constants the wrapper
// packs its arguments by.

#include <cstdint>
#include <cstddef>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define QH_FN __host__ __device__ __forceinline__
#define QH_UNROLL _Pragma("unroll")
#else
#include <vector>
#define QH_FN static inline
#define QH_UNROLL
#endif

namespace {

constexpr int kMaxP = 8;       // peer slots
constexpr int kMaxE = 8;       // entries per append
constexpr int kMaxW = 16;      // ring window (a power of two)
constexpr int kThreads = 128;  // threads per block of `pred` and `commit`

// ops/state.py's codes.
constexpr int kLeader = 2;
constexpr int kProbe = 0, kReplicate = 1;
constexpr int kNone = 0, kApp = 1, kAppResp = 2, kVote = 3, kVoteResp = 4,
              kHb = 5, kHbResp = 6;
constexpr int kCandidate = 1;
constexpr int kSnap = 1, kViolation = 2;
constexpr int fType = 0, fTerm = 1, fIndex = 2, fLogTerm = 3, fCommit = 4,
              fReject = 5, fHint = 6, fNent = 7, kFixed = 8;
constexpr int kAckAgeCap = 1 << 20;

enum Kernel { kPred = 0, kMsgs = 1, kCommit = 2, kRoute = 3 };

// The packed int arguments (ops/quiet_hop.py::_words).
enum Word {
  wG, wP, wW, wE, wHeartbeat, wElection, wFlowWindow, wTick, wForceHb,
  wGroupsPerBlock, wHasDrop, kWords
};

// The packed pointers (ops/quiet_hop.py::_PTRS, same order).
enum Ptr {
  pInbox, pTerm, pState, pElapsed, pLead, pCommit, pLast, pNeedHost, pMask,
  pLogTerm, pMatch, pNext, pPrState, pPaused, pAckAge, pPropCount,
  pPropSlot, pDrop,
  oElapsed, oLead, oCommit, oLast, oNeedHost, oLogTerm, oMatch, oNext,
  oPrState, oPaused, oAckAge, oInbox,
  sIdxJ, sMyT, sPrev, sPrevT, sSel, sResp, sHbFire, sPlan, sFlag,
  pStream, pDevice, kPtrs
};

struct Dims {
  int G, P, W, E, F, hb, et, efw, tick, force_hb, gpb, has_drop;
};

struct Args {
  const int32_t *inbox, *term, *state, *elapsed, *lead, *commit, *last,
      *need_host;
  const uint8_t* mask;
  const int32_t *log_term, *match, *next, *pr_state;
  const uint8_t* paused;
  const int32_t *ack_age, *prop_count, *prop_slot, *drop;
  int32_t *o_elapsed, *o_lead, *o_commit, *o_last, *o_need_host,
      *o_log_term, *o_match, *o_next, *o_pr_state;
  uint8_t* o_paused;
  int32_t *o_ack_age, *o_inbox;
  int32_t *idx_j, *my_t, *prev, *prev_t, *sel, *resp, *hb_fire, *plan,
      *flag;
};

// sel bits: the follower's sender slot, then its flags.
constexpr int kSelSlot = 15, kSelHas = 1 << 4, kSelApp = 1 << 5,
              kSelHb = 1 << 6, kSelMatchOk = 1 << 7;
// resp words per row: type, index, reject, hint (term is the row's).
constexpr int kRespWords = 4;

QH_FN int imin(int a, int b) { return a < b ? a : b; }
QH_FN int imax(int a, int b) { return a > b ? a : b; }

// x mod W (W a power of two), never negative, as torch.remainder gives.
QH_FN int wrap(int x, int W) { return x & (W - 1); }

QH_FN bool in_window(int last, int W, int idx) {
  return (idx > last - W && idx <= last) || idx == 0;
}

// ring[slot] of a register array, selected without a runtime index.
template <int N>
QH_FN int pick(const int (&a)[N], int slot) {
  int v = 0;
  QH_UNROLL
  for (int k = 0; k < N; ++k)
    if (k == slot) v = a[k];
  return v;
}

// ops/state.py::term_at on a row's ring held in registers.
QH_FN int term_at_regs(const int (&ring)[kMaxW], int last, int W, int idx) {
  const bool valid = idx > last - W && idx <= last && idx >= 1;
  return valid ? pick(ring, wrap(idx, W)) : 0;
}

// The same on a row's ring in device memory.
QH_FN int term_at_mem(const int32_t* ring, int last, int W, int idx) {
  const bool valid = idx > last - W && idx <= last && idx >= 1;
  return valid ? ring[wrap(idx, W)] : 0;
}

// ---------------------------------------------------------------------------
// pred: `_quiet_pred` for one group; false clears the flag.
// ---------------------------------------------------------------------------

QH_FN void group_pred(const Dims& d, const Args& a, int g) {
  const int P = d.P, F = d.F;
  bool bad = false;
  int leaders = 0;
  for (int p = 0; p < P; ++p) {
    const size_t r = (size_t)g * P + p;
    const bool act = a.mask[r] != 0;
    const int st = a.state[r];
    bad |= a.need_host[r] != 0;
    bad |= act && st == kCandidate;
    bad |= act && st != kLeader && a.elapsed[r] + 1 >= d.et && d.tick;
    leaders += act && st == kLeader;
    const int term = a.term[r];
    const int32_t* m = a.inbox + r * P * F;
    for (int q = 0; q < P; ++q, m += F) {
      const int mt = m[fType];
      bad |= mt != kNone &&
             (mt == kVote || mt == kVoteResp || m[fTerm] != term);
    }
  }
  if (bad || leaders > 1) *a.flag = 0;
}

// ---------------------------------------------------------------------------
// msgs: one row, its P inbox messages at `in` (shared memory on the card)
// ---------------------------------------------------------------------------

QH_FN void row_msgs(const Dims& d, const Args& a, int r, const int32_t* in) {
  const int P = d.P, W = d.W, E = d.E, F = d.F;
  const int p = r % P;
  const bool act = a.mask[r] != 0;
  const bool is_l = a.state[r] == kLeader;
  const int term = a.term[r], last = a.last[r], commit = a.commit[r];
  int nh = a.need_host[r];

  // Tick: the heartbeat timeout (the predicate rules out a draw).
  int el = a.elapsed[r] + d.tick;
  const bool hb_timeout = act && is_l && el >= d.hb && d.tick;
  int hb_fire = hb_timeout ? term : 0;
  if (hb_timeout) el = 0;
  bool resume = hb_timeout;
  if (d.force_hb && act && is_l) {
    hb_fire = term;
    resume = true;
  }

  int mt[kMaxP], nx[kMaxP], pr[kMaxP], pa[kMaxP], aa[kMaxP];
  const size_t rp = (size_t)r * P;
  int s = 0;
  bool has = false;
  QH_UNROLL
  for (int q = 0; q < kMaxP; ++q) {
    mt[q] = nx[q] = pr[q] = pa[q] = aa[q] = 0;
    if (q >= P) continue;
    mt[q] = a.match[rp + q];
    nx[q] = a.next[rp + q];
    pr[q] = a.pr_state[rp + q];
    pa[q] = a.paused[rp + q];
    aa[q] = imin(a.ack_age[rp + q] + 1, kAckAgeCap);
    if (is_l && q == p) {  // _set_self_progress
      mt[q] = last;
      nx[q] = last + 1;
    }
    if (resume) pa[q] = 0;

    // The leader's responses, every column at once.
    const int32_t* m = in + q * F;
    const int mtype = m[fType], mi = m[fIndex], mr = m[fReject];
    const bool ar = act && is_l && mtype == kAppResp;
    const bool ok = ar && mr == 0;
    const bool rej = ar && mr != 0;
    const bool repl_rej = rej && pr[q] == kReplicate && mi > mt[q];
    const bool probe_rej = rej && pr[q] == kProbe && nx[q] - 1 == mi;
    if (repl_rej) {
      nx[q] = mt[q] + 1;
      pr[q] = kProbe;
    }
    if (probe_rej) {
      nx[q] = imax(imin(mi, m[fHint] + 1), 1);
      pa[q] = 0;
    }
    if (ok && mt[q] < mi) {
      mt[q] = mi;
      pa[q] = 0;
      if (pr[q] == kProbe) pr[q] = kReplicate;
    }
    nx[q] = imax(nx[q], ok ? mi + 1 : 0);
    if (ar) aa[q] = 0;
    const bool hrs = act && is_l && mtype == kHbResp;
    if (hrs && pr[q] == kReplicate && mt[q] < last && aa[q] > 2 * d.hb + 2)
      nx[q] = mt[q] + 1;

    // The follower's first append-or-heartbeat.
    if (!has && act && !is_l && (mtype == kApp || mtype == kHb)) {
      has = true;
      s = q;
    }
  }

  const int32_t* m = in + s * F;
  const int mtype = has ? m[fType] : kNone;
  const int mi = has ? m[fIndex] : 0;
  const int mlt = has ? m[fLogTerm] : 0;
  const int mnent = has ? m[fNent] : 0;
  const bool fa = has && mtype == kApp, fh = has && mtype == kHb;
  int lead = a.lead[r];
  if (fa || fh) {
    el = 0;
    lead = s + 1;
  }
  int rtype = kNone, ridx = 0, rrej = 0, rhint = 0;
  const bool below = fa && mi < commit;
  if (below) {
    rtype = kAppResp;
    ridx = commit;
  }
  const bool chk = fa && !below;
  const int32_t* ring = a.log_term + (size_t)r * W;
  const bool piw = in_window(last, W, mi);
  const bool escape = chk && !piw && mi <= last;
  if (escape) nh |= kSnap;
  const bool match_ok =
      chk && !escape && piw && term_at_mem(ring, last, W, mi) == mlt;
  if (chk && !escape && !match_ok) {
    rtype = kAppResp;
    ridx = mi;
    rrej = 1;
    rhint = last;
  }
  if (match_ok) {
    rtype = kAppResp;
    ridx = mi + mnent;
  }
  if (fh) rtype = kHbResp;

  a.o_elapsed[r] = el;
  a.o_lead[r] = lead;
  a.o_need_host[r] = nh;
  QH_UNROLL
  for (int q = 0; q < kMaxP; ++q) {
    if (q >= P) continue;
    a.o_match[rp + q] = mt[q];
    a.o_next[rp + q] = nx[q];
    a.o_pr_state[rp + q] = pr[q];
    a.o_paused[rp + q] = (uint8_t)pa[q];
    a.o_ack_age[rp + q] = aa[q];
  }
  for (int j = 0; j < E; ++j) a.idx_j[(size_t)r * E + j] = mi + 1 + j;
  a.sel[r] = s | (has ? kSelHas : 0) | (fa ? kSelApp : 0) |
             (fh ? kSelHb : 0) | (match_ok ? kSelMatchOk : 0);
  int32_t* rs = a.resp + (size_t)r * kRespWords;
  rs[0] = rtype;
  rs[1] = ridx;
  rs[2] = rrej;
  rs[3] = rhint;
  a.hb_fire[r] = hb_fire;
}

// ---------------------------------------------------------------------------
// commit: one row, after the conflict scan's resolve (my_t)
// ---------------------------------------------------------------------------

// Descending sort of kMaxP values in registers (odd-even transposition:
// kMaxP rounds of compare-exchange). Values only: ties cannot change the
// result, as torch.topk(sorted=True).values.
QH_FN void sort_desc(int (&v)[kMaxP]) {
  QH_UNROLL
  for (int round = 0; round < kMaxP; ++round) {
    QH_UNROLL
    for (int k = round & 1; k + 1 < kMaxP; k += 2) {
      const int hi = imax(v[k], v[k + 1]), lo = imin(v[k], v[k + 1]);
      v[k] = hi;
      v[k + 1] = lo;
    }
  }
}

QH_FN void row_commit(const Dims& d, const Args& a, int r) {
  const int P = d.P, W = d.W, E = d.E, F = d.F;
  const int g = r / P, p = r - g * P;
  const bool act = a.mask[r] != 0;
  const bool is_l = a.state[r] == kLeader;
  const int term = a.term[r];
  int commit = a.commit[r], last = a.last[r];
  int nh = a.o_need_host[r];
  int ring[kMaxW];
  QH_UNROLL
  for (int w = 0; w < kMaxW; ++w)
    ring[w] = w < W ? a.log_term[(size_t)r * W + w] : 0;

  const int sel = a.sel[r];
  const int32_t* m = a.inbox + ((size_t)r * P + (sel & kSelSlot)) * F;
  if (sel & kSelMatchOk) {
    const int mi = m[fIndex], mnent = m[fNent];
    int ent[kMaxE];
    int first = -1;
    QH_UNROLL
    for (int j = 0; j < kMaxE; ++j) {
      ent[j] = j < E ? m[kFixed + j] : 0;
      if (j < E && first < 0 && j < mnent &&
          a.my_t[(size_t)r * E + j] != ent[j])
        first = j;
    }
    const int lastnewi = mi + mnent;
    if (first >= 0) {  // a conflict: write from it on, truncate the tail
      const int ci = mi + 1 + first;
      if (ci <= commit) nh |= kViolation;
      QH_UNROLL
      for (int w = 0; w < kMaxW; ++w) {
        if (w >= W) continue;
        const int jw = wrap(w - (mi + 1), W);
        if (jw < mnent && mi + 1 + jw >= ci) ring[w] = pick(ent, imin(jw, E - 1));
      }
      const int old_last = last;
      last = lastnewi;
      if (old_last > lastnewi) {
        QH_UNROLL
        for (int w = 0; w < kMaxW; ++w)
          if (w < W && old_last - wrap(old_last - w, W) > lastnewi)
            ring[w] = 0;
      }
    }
    commit = imax(commit, imin(m[fCommit], lastnewi));
  }
  if (sel & kSelHb) commit = imax(commit, imin(m[fCommit], last));

  // Proposal admission at prop_slot.
  const bool admit = act && p == a.prop_slot[g] && is_l;
  const int room = imax(W / 2 - (last - commit), 0);
  const int cnt = admit ? imin(imin(a.prop_count[g], E), room) : 0;
  if (cnt > 0) {
    QH_UNROLL
    for (int w = 0; w < kMaxW; ++w)
      if (w < W && wrap(w - (last + 1), W) < cnt) ring[w] = term;
  }
  last += cnt;

  // Self progress, then the quorum commit over the group's live slots.
  const size_t rp = (size_t)r * P;
  int mt[kMaxP], nx[kMaxP], pr[kMaxP], pa[kMaxP], vals[kMaxP];
  bool live[kMaxP];
  int n_live = 0;
  QH_UNROLL
  for (int q = 0; q < kMaxP; ++q) {
    mt[q] = nx[q] = pr[q] = pa[q] = 0;
    live[q] = false;
    vals[q] = INT32_MIN;
    if (q >= P) continue;
    mt[q] = a.o_match[rp + q];
    nx[q] = a.o_next[rp + q];
    pr[q] = a.o_pr_state[rp + q];
    pa[q] = a.o_paused[rp + q];
    if (is_l && q == p) {
      mt[q] = last;
      nx[q] = last + 1;
    }
    live[q] = a.mask[(size_t)g * P + q] != 0;
    n_live += live[q];
    vals[q] = live[q] ? (q == p ? last : mt[q]) : -1;
  }
  sort_desc(vals);
  const int mci = pick(vals, n_live / 2);  // the quorum's (n/2 + 1)-th
  const int eff_term = is_l ? term : 0;
  if (eff_term > 0 && mci > commit &&
      term_at_regs(ring, last, W, imax(mci, 0)) == eff_term)
    commit = mci;

  // The send plan, and the optimistic progress of the appends it sends.
  const int hb_fire = a.hb_fire[r];
  const bool hb_ok = hb_fire == term && hb_fire > 0;
  int app_bits = 0, hb_bits = 0, counts = 0;
  QH_UNROLL
  for (int q = 0; q < kMaxP; ++q) {
    if (q >= P) continue;
    const bool tgt = live[q] && act && q != p;
    const bool paused_eff =
        pr[q] == kProbe ? pa[q] != 0 : nx[q] - 1 - mt[q] >= d.efw;
    const bool gap = nx[q] <= last;
    const int prev = nx[q] - 1;
    const bool sendable = in_window(last, W, prev) && nx[q] > last - W;
    if (is_l && tgt && gap && !sendable) nh |= kSnap;
    const bool send = is_l && tgt && gap && !paused_eff && sendable;
    a.prev[rp + q] = prev;
    if (send) {
      const int n = imin(last - nx[q] + 1, E);
      app_bits |= 1 << q;
      counts |= n << (4 * q);
      if (pr[q] == kReplicate) nx[q] += n;
      if (pr[q] == kProbe) pa[q] = 1;
    } else if (is_l && tgt && hb_ok) {
      hb_bits |= 1 << q;
    }
  }
  if (act && commit > last) nh |= kViolation;

  QH_UNROLL
  for (int w = 0; w < kMaxW; ++w)
    if (w < W) a.o_log_term[(size_t)r * W + w] = ring[w];
  a.o_last[r] = last;
  a.o_commit[r] = commit;
  a.o_need_host[r] = nh;
  QH_UNROLL
  for (int q = 0; q < kMaxP; ++q) {
    if (q >= P) continue;
    a.o_match[rp + q] = mt[q];
    a.o_next[rp + q] = nx[q];
    a.o_paused[rp + q] = (uint8_t)pa[q];
  }
  a.plan[2 * (size_t)r] = app_bits | (hb_bits << 8);
  a.plan[2 * (size_t)r + 1] = counts;
}

// ---------------------------------------------------------------------------
// route: one row's outbox into its group's routed mailbox `og` (shared
// memory on the card), message (to q, from p) at og[(q * P + p) * F]
// ---------------------------------------------------------------------------

QH_FN void row_route(const Dims& d, const Args& a, int r, int32_t* og) {
  const int P = d.P, W = d.W, F = d.F;
  const int p = r % P;
  const int term = a.term[r], commit = a.o_commit[r];
  const int32_t* ring = a.o_log_term + (size_t)r * W;
  const int app_bits = a.plan[2 * (size_t)r] & 0xff;
  const int hb_bits = a.plan[2 * (size_t)r] >> 8;
  const int counts = a.plan[2 * (size_t)r + 1];
  const int s = a.sel[r] & kSelSlot;
  const int32_t* rs = a.resp + (size_t)r * kRespWords;
  const size_t rp = (size_t)r * P;
  for (int q = 0; q < P; ++q) {
    int32_t* o = og + (q * P + p) * F;
    for (int f = 0; f < F; ++f) o[f] = 0;
    if (q == s && rs[0] != kNone) {  // responses override everything
      o[fType] = rs[0];
      o[fTerm] = term;
      o[fIndex] = rs[1];
      o[fReject] = rs[2];
      o[fHint] = rs[3];
    } else if (app_bits >> q & 1) {
      const int n = counts >> (4 * q) & 15, prev = a.prev[rp + q];
      o[fType] = kApp;
      o[fTerm] = term;
      o[fIndex] = prev;
      o[fLogTerm] = a.prev_t[rp + q];
      o[fCommit] = commit;
      o[fNent] = n;
      for (int j = 0; j < n; ++j) o[kFixed + j] = ring[wrap(prev + 1 + j, W)];
    } else if (hb_bits >> q & 1) {
      o[fType] = kHb;
      o[fTerm] = term;
      o[fCommit] = imin(a.o_match[rp + q], commit);
    }
  }
}

// A block's groups [g0, g0 + ng): their mailboxes are contiguous.
QH_FN size_t group_words(const Dims& d) { return (size_t)d.P * d.P * d.F; }

// The routed mailbox words [0, n) of the groups from g0, from `sm` into
// the routed inbox, each times its (g, to, from) drop-mask word.
QH_FN void store_routed(const Dims& d, const Args& a, int g0,
                        const int32_t* sm, size_t n, size_t i, size_t step) {
  const size_t base = (size_t)g0 * group_words(d);
  for (; i < n; i += step) {
    const int32_t v = sm[i];
    a.o_inbox[base + i] = d.has_drop ? v * a.drop[(base + i) / d.F] : v;
  }
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(kThreads) qh_pred(Dims d, Args a) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < d.G) group_pred(d, a, g);
}

__global__ void qh_msgs(Dims d, Args a) {
  extern __shared__ int32_t sm[];
  const int g0 = blockIdx.x * d.gpb;
  const int ng = imin(d.gpb, d.G - g0);
  const size_t n = (size_t)ng * group_words(d);
  const int32_t* src = a.inbox + (size_t)g0 * group_words(d);
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) sm[i] = src[i];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < ng * d.P)
    row_msgs(d, a, g0 * d.P + t, sm + (size_t)t * d.P * d.F);
}

__global__ void __launch_bounds__(kThreads) qh_commit(Dims d, Args a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r < d.G * d.P) row_commit(d, a, r);
}

__global__ void qh_route(Dims d, Args a) {
  extern __shared__ int32_t sm[];
  const int g0 = blockIdx.x * d.gpb;
  const int ng = imin(d.gpb, d.G - g0);
  const int t = threadIdx.x;
  if (t < ng * d.P) {
    const int gl = t / d.P;
    row_route(d, a, g0 * d.P + t, sm + (size_t)gl * group_words(d));
  }
  __syncthreads();
  store_routed(d, a, g0, sm, (size_t)ng * group_words(d), threadIdx.x,
               blockDim.x);
}

struct DeviceGuard {
  int prev = -1, dev;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int dv) : dev(dv) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != dev) cudaSetDevice(prev);
  }
};

#endif  // __CUDACC__

bool unpack(const int* words, const int64_t* ptrs, Dims* d, Args* a) {
  d->G = words[wG];
  d->P = words[wP];
  d->W = words[wW];
  d->E = words[wE];
  d->F = kFixed + d->E;
  d->hb = words[wHeartbeat];
  d->et = words[wElection];
  d->efw = words[wFlowWindow];
  d->tick = words[wTick] != 0;
  d->force_hb = words[wForceHb] != 0;
  d->gpb = words[wGroupsPerBlock];
  d->has_drop = words[wHasDrop] != 0;
  if (d->G < 1 || d->P < 1 || d->P > kMaxP || d->E < 1 || d->E > kMaxE ||
      d->W < 2 || d->W > kMaxW || (d->W & (d->W - 1)) != 0 || d->gpb < 1)
    return false;
#define QH_PTR(field, slot) a->field = (decltype(a->field))ptrs[slot]
  QH_PTR(inbox, pInbox); QH_PTR(term, pTerm); QH_PTR(state, pState);
  QH_PTR(elapsed, pElapsed); QH_PTR(lead, pLead); QH_PTR(commit, pCommit);
  QH_PTR(last, pLast); QH_PTR(need_host, pNeedHost); QH_PTR(mask, pMask);
  QH_PTR(log_term, pLogTerm); QH_PTR(match, pMatch); QH_PTR(next, pNext);
  QH_PTR(pr_state, pPrState); QH_PTR(paused, pPaused);
  QH_PTR(ack_age, pAckAge); QH_PTR(prop_count, pPropCount);
  QH_PTR(prop_slot, pPropSlot); QH_PTR(drop, pDrop);
  QH_PTR(o_elapsed, oElapsed); QH_PTR(o_lead, oLead);
  QH_PTR(o_commit, oCommit); QH_PTR(o_last, oLast);
  QH_PTR(o_need_host, oNeedHost); QH_PTR(o_log_term, oLogTerm);
  QH_PTR(o_match, oMatch); QH_PTR(o_next, oNext);
  QH_PTR(o_pr_state, oPrState); QH_PTR(o_paused, oPaused);
  QH_PTR(o_ack_age, oAckAge); QH_PTR(o_inbox, oInbox);
  QH_PTR(idx_j, sIdxJ); QH_PTR(my_t, sMyT); QH_PTR(prev, sPrev);
  QH_PTR(prev_t, sPrevT); QH_PTR(sel, sSel); QH_PTR(resp, sResp);
  QH_PTR(hb_fire, sHbFire); QH_PTR(plan, sPlan); QH_PTR(flag, sFlag);
#undef QH_PTR
  return true;
}

}  // namespace

// {words, pointers, max P, max E, max W, threads of pred/commit, the
// Kernel ids kPred, kMsgs, kCommit, kRoute}. Returns how many ints it
// wrote (at most n).
extern "C" int quiet_hop_layout(int* out, int n) {
  const int v[] = {kWords, kPtrs, kMaxP, kMaxE, kMaxW, kThreads,
                   kPred,  kMsgs, kCommit, kRoute};
  const int k = n < 10 ? n : 10;
  for (int j = 0; j < k; ++j) out[j] = v[j];
  return k;
}

// One pass. words: the Word enum; ptrs: the Ptr enum (the stream and the
// device last). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue (1) for arguments it does not take.
extern "C" int quiet_hop_launch(int kernel, const int* words,
                                const int64_t* ptrs) {
  Dims d;
  Args a;
  if (!unpack(words, ptrs, &d, &a) || kernel < kPred || kernel > kRoute)
    return 1;
  const int blocks_rows = (d.G * d.P + kThreads - 1) / kThreads;
  const int blocks_groups = (d.G + d.gpb - 1) / d.gpb;
  const size_t smem = (size_t)d.gpb * group_words(d) * sizeof(int32_t);
#ifdef __CUDACC__
  cudaStream_t st = (cudaStream_t)ptrs[pStream];
  DeviceGuard guard((int)ptrs[pDevice]);
  if (guard.err != cudaSuccess) return (int)guard.err;
  switch (kernel) {
    case kPred:
      qh_pred<<<(d.G + kThreads - 1) / kThreads, kThreads, 0, st>>>(d, a);
      break;
    case kMsgs:
      qh_msgs<<<blocks_groups, d.gpb * d.P, smem, st>>>(d, a);
      break;
    case kCommit:
      qh_commit<<<blocks_rows, kThreads, 0, st>>>(d, a);
      break;
    case kRoute:
      qh_route<<<blocks_groups, d.gpb * d.P, smem, st>>>(d, a);
      break;
  }
  return (int)cudaGetLastError();
#else
  // The host build: every block in turn, every thread of a block in turn
  // between its barriers.
  (void)blocks_rows;
  std::vector<int32_t> sm(smem / sizeof(int32_t));
  switch (kernel) {
    case kPred:
      for (int g = 0; g < d.G; ++g) group_pred(d, a, g);
      break;
    case kMsgs:
      for (int b = 0; b < blocks_groups; ++b) {
        const int g0 = b * d.gpb, ng = imin(d.gpb, d.G - g0);
        const size_t n = (size_t)ng * group_words(d);
        const int32_t* src = a.inbox + (size_t)g0 * group_words(d);
        for (size_t i = 0; i < n; ++i) sm[i] = src[i];
        for (int t = 0; t < ng * d.P; ++t)
          row_msgs(d, a, g0 * d.P + t, sm.data() + (size_t)t * d.P * d.F);
      }
      break;
    case kCommit:
      for (int r = 0; r < d.G * d.P; ++r) row_commit(d, a, r);
      break;
    case kRoute:
      for (int b = 0; b < blocks_groups; ++b) {
        const int g0 = b * d.gpb, ng = imin(d.gpb, d.G - g0);
        for (int t = 0; t < ng * d.P; ++t)
          row_route(d, a, g0 * d.P + t,
                    sm.data() + (size_t)(t / d.P) * group_words(d));
        store_routed(d, a, g0, sm.data(), (size_t)ng * group_words(d), 0, 1);
      }
      break;
  }
  return 0;
#endif
}

"""The batched consensus round in PyTorch: G Raft groups × P peer slots
stepped as dense tensor programs on one device.

The counterpart of the JAX package's `ops/kernel.py`, function by
function, with the same names, signatures and phase order, and
bit-identical trajectories (tests/test_torch_kernel.py drives both):

- tick scan             -> vectorized elapsed/timeout update over (G, P)
- Step(m) per message   -> masked updates, one pass per sender slot
- maybeCommit sort      -> torch.topk over the peers axis
- bcastAppend/sendAppend -> gap-driven send assembly over (G, P, P)
- message routing       -> a transpose of the (G, P_from, P_to) outbox

Design rules (shared with the JAX package): the dense mailbox keeps one
slot per (sender, target) pair and drops lower-priority collisions;
sends are gap-driven; rare transitions escape to the host through
`need_host`; flow control counts entries in flight.

What differs from the JAX program:

- The windowed ring-term resolve (`_terms_at_many`) is the hand-written
  CUDA kernel `ops/ring_resolve.py` on the card. Every round function
  takes `resolve=` (default `ring_resolve`) so a caller can run the same
  round with the plain version.
- JAX selects the quiescent fast path with `lax.cond` on device; here
  each hop reads `_quiet_pred` back to the host once (one device sync
  per hop) and runs exactly one of the two message phases.
- Functions never write into their inputs: the engine keeps references
  to earlier states (the compact diff compares against the pre-round
  state).
- The sharded round (the device mesh, parallel/mesh.py): JAX runs one
  program over sharded arrays and XLA inserts the collectives. Here
  `step_routed_auto`, `step_routed_read_auto` and
  `step_routed_slots_auto` also run on a block: peer columns
  [c0, c0 + Pb) of a block of groups, with a comm (parallel/comm.py) for
  the points where the block needs other columns. Every global slot id
  is c0 plus the local column; the target-peer axis (match, next, ...)
  and the inbox's sender axis hold all P columns in every block. The
  cross-block points: the peer_mask of every column, gathered once per
  call (the target axis's `active` and the quorum size); the quiescence
  vote per hop (a per-group sum of leaders, then one global "any", so
  every block takes the same branch); the route per hop (an all-to-all);
  and the read plane's register and tally (gathers and sums over
  peers). With c0 = 0 and no comm a block holds every column and the
  functions are the unsharded round.
- `tick` is a Python bool.
- The JAX package donates the state and inbox buffers of its jitted
  rounds (`donate_safe`, which also keeps XLA:CPU off donation). Eager
  PyTorch has no donation: a round allocates its outputs, and a caller
  frees the inputs by dropping its references.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from etcd_tpu_torch.ops.ring_resolve import ring_resolve
from etcd_tpu_torch.ops.state import (CANDIDATE, FOLLOWER, F_COMMIT, F_HINT,
                                      F_INDEX, F_LOGTERM, F_NENT, F_REJECT,
                                      F_TERM, F_TYPE, GroupState,
                                      KernelConfig, LEADER, M_APP,
                                      M_APP_RESP, M_HB, M_HB_RESP, M_NONE,
                                      M_VOTE, M_VOTE_RESP, N_FIXED_FIELDS,
                                      NH_SNAP, NH_VIOLATION, PR_PROBE,
                                      PR_REPLICATE, active_mask, in_window,
                                      ring_lookup, term_at,
                                      xorshift32)

I32 = torch.int32


def _flag(need_host: torch.Tensor, mask: torch.Tensor,
          bit: int) -> torch.Tensor:
    """OR an NH_* bit into the (G, P) need_host bitmask where mask holds."""
    return need_host | torch.where(mask, bit, 0).to(I32)


def _where(m, a, b):
    return torch.where(m, a, b)


def _ar(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


def _slot_ids(st: GroupState, c0: int) -> torch.Tensor:
    """(Pb,) global slot index of each of the block's peer columns."""
    return c0 + _ar(st.term.shape[1], st.term)


def _self_eye(st: GroupState, c0: int) -> torch.Tensor:
    """(1, Pb, P) bool: row p's own slot on the target-peer axis (the
    identity when the block holds every column)."""
    P = st.match.shape[2]
    return (_slot_ids(st, c0)[:, None] == _ar(P, st.term)[None, :])[None]


class _Blk(NamedTuple):
    """The block a round runs on: its first global peer column, its comm
    (None when it holds every column), and what it needs of every column:
    the (G, P) peer_mask and the (G,) quorum size."""
    c0: int
    comm: object
    mask: torch.Tensor
    qr: torch.Tensor


def _block(st: GroupState, c0: int, comm) -> _Blk:
    """The round's view of its block; one gather of the peer_mask over
    the peers cells when sharded (the kernel never changes the mask)."""
    if comm is None:
        if c0 != 0 or st.term.shape[1] != st.match.shape[2]:
            raise ValueError("a block of peer columns needs a comm")
        mask = st.peer_mask
    else:
        mask = comm.gather_peers(st.peer_mask.to(I32)) != 0
    return _Blk(c0, comm, mask, mask.sum(dim=1, dtype=I32) // 2 + 1)


def _first_true(m: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first true element along `dim` (0 where none), int32 —
    argmax over bool, which torch does not take, without depending on a
    backend's tie order."""
    n = m.shape[dim]
    shape = [1] * m.ndim
    shape[dim] = n
    ar = _ar(n, m).reshape(shape)
    first = torch.where(m, ar, n).amin(dim=dim)
    return torch.where(first == n, 0, first).to(I32)


def _set_col(x: torch.Tensor, q: int, col: torch.Tensor) -> torch.Tensor:
    """x with x[:, :, q] replaced by col (a fresh tensor; x untouched)."""
    out = x.clone()
    out[:, :, q] = col
    return out


def _last_term(st: GroupState, cfg: KernelConfig) -> torch.Tensor:
    return term_at(st, cfg, st.last_index)


def _set_self_progress(st: GroupState, c0: int = 0) -> GroupState:
    """Leader's own match tracks its last index."""
    eye = _self_eye(st, c0)
    is_ldr = (st.state == LEADER)[..., None]
    match = _where(eye & is_ldr, st.last_index[..., None], st.match)
    nxt = _where(eye & is_ldr, st.last_index[..., None] + 1, st.next)
    return st._replace(match=match, next=nxt)


def _become_follower(st: GroupState, mask: torch.Tensor,
                     new_term: torch.Tensor, new_lead) -> GroupState:
    """Masked becomeFollower(term, lead); vote cleared only when the term
    actually changes."""
    term_changed = mask & (new_term != st.term)
    return st._replace(
        term=_where(mask, new_term, st.term),
        vote=_where(term_changed, 0, st.vote),
        lead=_where(mask, new_lead, st.lead).to(I32),
        state=_where(mask, FOLLOWER, st.state),
        elapsed=_where(mask, 0, st.elapsed),
        votes=_where(mask[..., None], 0, st.votes),
    )


def _append_noop_and_lead(st: GroupState, cfg: KernelConfig,
                          win: torch.Tensor, c0: int = 0) -> GroupState:
    """Masked becomeLeader: reset progress, append the no-op entry of the
    new term."""
    new_last = st.last_index + 1
    st = _write_terms(st, cfg, anchor=st.last_index,
                      terms=st.term[..., None], lo=new_last,
                      count=win.to(I32), mask=win)
    w3 = win[..., None]
    st = st._replace(
        state=_where(win, LEADER, st.state),
        lead=_where(win, _slot_ids(st, c0)[None, :] + 1, st.lead),
        elapsed=_where(win, 0, st.elapsed),
        last_index=_where(win, new_last, st.last_index),
        # Probe from the pre-no-op last+1 so the no-op itself replicates.
        match=_where(w3, 0, st.match),
        next=_where(w3, new_last[..., None], st.next),
        pr_state=_where(w3, PR_PROBE, st.pr_state),
        paused=_where(w3, False, st.paused),
        ack_age=_where(w3, 0, st.ack_age),
    )
    return _set_self_progress(st, c0)


# ---------------------------------------------------------------------------
# Phase 1: tick
# ---------------------------------------------------------------------------

def _tick(st: GroupState, cfg: KernelConfig, active: torch.Tensor,
          tick: bool, blk: _Blk
          ) -> Tuple[GroupState, torch.Tensor, torch.Tensor]:
    """Advance the logical clock one tick where `tick` is set. Returns
    (state, hb_fire_term, vote_fire_term): the term at which a heartbeat /
    vote broadcast was staged this round (0 = none)."""
    tick = bool(tick)
    is_ldr = st.state == LEADER
    elapsed = st.elapsed + int(tick)

    # Leaders: heartbeat timeout.
    hb_timeout = active & is_ldr & (elapsed >= cfg.heartbeat_tick) & tick
    hb_fire_term = _where(hb_timeout, st.term, 0)

    # Followers/candidates: randomized election timeout. The draw is the
    # unsigned xorshift lane modulo election_tick.
    d = elapsed - cfg.election_tick
    draw = active & ~is_ldr & (d >= 0) & tick
    prng = _where(draw, xorshift32(st.prng), st.prng)
    timeout = draw & (d > torch.remainder(prng, cfg.election_tick))

    st = st._replace(
        prng=prng,
        elapsed=_where(hb_timeout | timeout, 0, elapsed),
    )

    # Campaign: term+1, vote self, tally own vote; single-voter groups win
    # instantly.
    camp = timeout
    self_id = _slot_ids(st, blk.c0)[None, :] + 1
    c3 = camp[..., None]
    votes = _where(c3, 0, st.votes)
    votes = _where(c3 & _self_eye(st, blk.c0), 1, votes)
    st = st._replace(
        term=_where(camp, st.term + 1, st.term),
        vote=_where(camp, self_id, st.vote),
        lead=_where(camp, 0, st.lead),
        state=_where(camp, CANDIDATE, st.state),
        votes=votes,
        paused=_where(c3, False, st.paused),
    )
    instant_win = camp & (blk.qr[:, None] == 1)
    st = _append_noop_and_lead(st, cfg, instant_win, blk.c0)
    vote_fire_term = _where(camp & ~instant_win, st.term, 0)

    # Heartbeat broadcast resumes all paused probes.
    st = st._replace(paused=_where(hb_timeout[..., None], False, st.paused))
    return st, hb_fire_term, vote_fire_term


# ---------------------------------------------------------------------------
# Phase 2: one sender slot's messages, for all instances at once
# ---------------------------------------------------------------------------

def _step_msgs_from(st: GroupState, cfg: KernelConfig, q: int,
                    msg: torch.Tensor, active: torch.Tensor,
                    blk: _Blk, resolve=ring_resolve
                    ) -> Tuple[GroupState, torch.Tensor]:
    """Process the inbox slot from sender `q` on every instance; returns
    the updated state and the staged response (G, P, F) addressed to q."""
    G, P = st.term.shape
    F = cfg.fields
    mtype = msg[..., F_TYPE]
    mterm = msg[..., F_TERM]
    mindex = msg[..., F_INDEX]
    mlogterm = msg[..., F_LOGTERM]
    mcommit = msg[..., F_COMMIT]
    mreject = msg[..., F_REJECT]
    mhint = msg[..., F_HINT]
    mnent = msg[..., F_NENT]
    ent_terms = msg[..., N_FIXED_FIELDS:]

    has = active & (mtype != M_NONE)
    resp = torch.zeros((G, P, F), dtype=I32, device=st.term.device)

    # -- term gate ---------------------------------------------------------
    higher = has & (mterm > st.term)
    lead_on_higher = _where(mtype == M_VOTE, 0, q + 1).to(I32)
    st = _become_follower(st, higher, mterm, lead_on_higher)
    live = has & (mterm == st.term)  # stale (lower-term) messages ignored

    is_c = st.state == CANDIDATE

    # -- MsgApp / MsgHeartbeat demote same-term candidates -----------------
    demote = live & is_c & ((mtype == M_APP) | (mtype == M_HB))
    st = _become_follower(st, demote, st.term, q + 1)
    is_c = st.state == CANDIDATE

    # -- MsgVote -------------------------------------------------------------
    v = live & (mtype == M_VOTE)
    last_t = _last_term(st, cfg)
    up_to_date = (mlogterm > last_t) | ((mlogterm == last_t)
                                        & (mindex >= st.last_index))
    grant = v & ((st.vote == 0) | (st.vote == q + 1)) & up_to_date
    st = st._replace(
        vote=_where(grant, q + 1, st.vote),
        elapsed=_where(grant, 0, st.elapsed),
    )
    resp = _stage(resp, v, M_VOTE_RESP, st.term, reject=~grant)

    # -- MsgVoteResp ---------------------------------------------------------
    vr = live & is_c & (mtype == M_VOTE_RESP)
    first = st.votes[:, :, q] == 0
    vote_val = _where(mreject == 0, 1, 2).to(I32)
    votes = _set_col(st.votes, q,
                     _where(vr & first, vote_val, st.votes[:, :, q]))
    st = st._replace(votes=votes)
    granted = (votes == 1).sum(dim=2, dtype=I32)
    rejected = (votes == 2).sum(dim=2, dtype=I32)
    qr = blk.qr[:, None]
    win = vr & (granted >= qr)
    lose = vr & ~win & (rejected >= qr)
    st = _append_noop_and_lead(st, cfg, win, blk.c0)
    st = _become_follower(st, lose, st.term, 0)
    is_l = st.state == LEADER

    # -- MsgApp ----------------------------------------------------------------
    a = live & (mtype == M_APP) & ~is_l
    st = st._replace(
        elapsed=_where(a, 0, st.elapsed),
        lead=_where(a, q + 1, st.lead),
    )
    below_commit = a & (mindex < st.commit)
    resp = _stage(resp, below_commit, M_APP_RESP, st.term, index=st.commit)

    chk = a & ~below_commit
    prev_t = term_at(st, cfg, mindex)
    prev_in_win = in_window(st, cfg, mindex)
    # Below the device window (but >= commit): the host resolves it.
    escape = chk & ~prev_in_win & (mindex <= st.last_index)
    st = st._replace(need_host=_flag(st.need_host, escape, NH_SNAP))

    match_ok = chk & ~escape & prev_in_win & (prev_t == mlogterm)
    rej = chk & ~escape & ~match_ok
    resp = _stage(resp, rej, M_APP_RESP, st.term, index=mindex,
                  reject=True, hint=st.last_index)

    # Conflict scan + append over the E entry slots.
    E = cfg.max_ents
    arE = _ar(E, st.term)[None, None]
    idx_j = mindex[..., None] + 1 + arE
    valid_j = arE < mnent[..., None]
    my_t = _terms_at_many(st, cfg, idx_j, resolve)
    mismatch = valid_j & (my_t != ent_terms)
    any_conf = match_ok & mismatch.any(dim=-1)
    first_j = _first_true(mismatch)
    ci = _where(any_conf, mindex + 1 + first_j, 0)
    # Conflicting with a committed entry is a protocol violation.
    st = st._replace(need_host=_flag(st.need_host,
                                     any_conf & (ci <= st.commit),
                                     NH_VIOLATION))

    st = _write_terms(st, cfg, anchor=mindex, terms=ent_terms, lo=ci,
                      count=mnent, mask=any_conf)
    st = _truncate_tail(st, cfg, any_conf, mindex + mnent)
    lastnewi = mindex + mnent
    new_commit = torch.maximum(st.commit, torch.minimum(mcommit, lastnewi))
    st = st._replace(commit=_where(match_ok, new_commit, st.commit))
    resp = _stage(resp, match_ok, M_APP_RESP, st.term, index=lastnewi)

    # -- MsgAppResp -------------------------------------------------------------
    ar = live & is_l & (mtype == M_APP_RESP)
    match_q = st.match[:, :, q]
    next_q = st.next[:, :, q]
    pr_q = st.pr_state[:, :, q]
    paused_q = st.paused[:, :, q]

    rej_resp = ar & (mreject != 0)
    repl_rej = rej_resp & (pr_q == PR_REPLICATE) & (mindex > match_q)
    probe_rej = rej_resp & (pr_q == PR_PROBE) & (next_q - 1 == mindex)
    next_q = _where(repl_rej, match_q + 1, next_q)
    next_q = _where(probe_rej,
                    torch.minimum(mindex, mhint + 1).clamp_min(1), next_q)
    pr_q = _where(repl_rej, PR_PROBE, pr_q)
    paused_q = _where(probe_rej, False, paused_q)

    ok_resp = ar & (mreject == 0)
    upd = ok_resp & (match_q < mindex)
    match_q = _where(upd, mindex, match_q)
    paused_q = _where(upd, False, paused_q)
    pr_q = _where(upd & (pr_q == PR_PROBE), PR_REPLICATE, pr_q)
    next_q = torch.maximum(next_q, _where(ok_resp, mindex + 1, 0))

    st = st._replace(
        match=_set_col(st.match, q, match_q),
        next=_set_col(st.next, q, next_q),
        pr_state=_set_col(st.pr_state, q, pr_q),
        paused=_set_col(st.paused, q, paused_q),
        ack_age=_set_col(st.ack_age, q, _where(ar, 0, st.ack_age[:, :, q])),
    )

    # -- MsgHeartbeat ------------------------------------------------------------
    h = live & (mtype == M_HB) & ~is_l
    st = st._replace(
        elapsed=_where(h, 0, st.elapsed),
        lead=_where(h, q + 1, st.lead),
        commit=_where(h, torch.maximum(st.commit,
                                       torch.minimum(mcommit, st.last_index)),
                      st.commit),
    )
    resp = _stage(resp, h, M_HB_RESP, st.term)

    # -- MsgHeartbeatResp: staleness-driven retransmission --------------------
    hrs = live & is_l & (mtype == M_HB_RESP)
    match_h = st.match[:, :, q]
    stale = (hrs & (st.pr_state[:, :, q] == PR_REPLICATE)
             & (match_h < st.last_index)
             & (st.ack_age[:, :, q] > 2 * cfg.heartbeat_tick + 2))
    st = st._replace(next=_set_col(
        st.next, q, _where(stale, match_h + 1, st.next[:, :, q])))
    return st, resp


def _truncate_tail(st: GroupState, cfg: KernelConfig,
                   do_append: torch.Tensor,
                   lastnewi: torch.Tensor) -> GroupState:
    """Set last_index to lastnewi where an append happened and zero the
    ring slots a SHRINKING truncation strands (their indices alias W lower
    inside the window, but those entries' true terms are long gone)."""
    old_last = st.last_index
    st = st._replace(last_index=_where(do_append, lastnewi, st.last_index))
    shrink = do_append & (old_last > lastnewi)
    w_idx = _ar(cfg.window, st.term)[None, None, :]
    i_w = old_last[..., None] - torch.remainder(old_last[..., None] - w_idx,
                                                cfg.window)
    strand = shrink[..., None] & (i_w > lastnewi[..., None])
    return st._replace(log_term=_where(strand, 0, st.log_term))


def _stage(resp: torch.Tensor, mask: torch.Tensor, mtype: int,
           term: torch.Tensor, index=None, reject=None,
           hint=None) -> torch.Tensor:
    """Write a response message into `resp` (G, P, F) where mask holds.
    Later stages win slot collisions. `resp` is a local buffer of the
    caller and is updated in place."""
    resp[..., F_TYPE] = _where(mask, mtype, resp[..., F_TYPE])
    resp[..., F_TERM] = _where(mask, term, resp[..., F_TERM])
    if index is not None:
        resp[..., F_INDEX] = _where(mask, index, resp[..., F_INDEX])
    if reject is not None:
        rej = int(reject) if isinstance(reject, bool) else reject.to(I32)
        resp[..., F_REJECT] = _where(mask, rej, resp[..., F_REJECT])
    if hint is not None:
        resp[..., F_HINT] = _where(mask, hint, resp[..., F_HINT])
    return resp


def _terms_at_many(st: GroupState, cfg: KernelConfig, idx: torch.Tensor,
                   resolve=ring_resolve) -> torch.Tensor:
    """term_at for extra trailing axes of indices: idx (G, P, *T) ->
    terms (G, P, *T); 0 outside the window / beyond last. On the card this
    is the CUDA kernel `ring_resolve`."""
    return resolve(st.log_term.contiguous(), idx.to(I32).contiguous(),
                   st.last_index.contiguous())


def _write_terms(st: GroupState, cfg: KernelConfig, anchor: torch.Tensor,
                 terms: torch.Tensor, lo: torch.Tensor, count: torch.Tensor,
                 mask: torch.Tensor) -> GroupState:
    """Write entry terms for the index range (max(lo, anchor+1) ..
    anchor+count] into the log ring, where entry anchor+1+j takes
    terms[..., j]. Ring slot w maps to at most one index in the range
    (count <= E < W): j_w = (w - (anchor+1)) mod W.

    anchor/lo/count: (G, P); terms: (G, P, E); mask: (G, P)."""
    W = cfg.window
    E = terms.shape[-1]
    w_idx = _ar(W, st.term)[None, None, :]
    j_w = torch.remainder(w_idx - (anchor[..., None] + 1), W)
    idx_w = anchor[..., None] + 1 + j_w
    write = (mask[..., None] & (j_w < count[..., None])
             & (idx_w >= lo[..., None]))
    val = ring_lookup(terms, j_w.clamp_max(E - 1))
    return st._replace(log_term=_where(write, val, st.log_term))


# ---------------------------------------------------------------------------
# Phase 3: proposals
# ---------------------------------------------------------------------------

def _apply_proposals_slots(st: GroupState, cfg: KernelConfig,
                           cnt_gp: torch.Tensor, active: torch.Tensor,
                           c0: int = 0) -> GroupState:
    """Per-slot proposal admission for the multi-host engine: cnt_gp is
    (G, P), and each host stages proposals only at its own leader slots.
    Semantics match _apply_proposals with prop_slot = the slot whose count
    is nonzero; non-leader slots admit nothing."""
    is_ldr = active & (st.state == LEADER)
    tail = st.last_index - st.commit
    room = (cfg.window // 2 - tail).clamp_min(0)
    cnt = torch.minimum(cnt_gp.clamp_max(cfg.max_ents), room)
    cnt = (cnt * is_ldr.to(I32)).to(I32)
    E = cfg.max_ents
    terms = st.term[..., None].expand(*st.term.shape, E)
    st = _write_terms(st, cfg, anchor=st.last_index, terms=terms,
                      lo=st.last_index + 1, count=cnt, mask=cnt > 0)
    st = st._replace(last_index=st.last_index + cnt)
    return _set_self_progress(st, c0)


def _apply_proposals(st: GroupState, cfg: KernelConfig,
                     prop_count: torch.Tensor, prop_slot: torch.Tensor,
                     active: torch.Tensor, c0: int = 0) -> GroupState:
    """The addressed leader appends `prop_count[g]` new entries of its
    term; only the instance at `prop_slot[g]` appends. Admission never
    lets the uncommitted tail outrun half the ring window."""
    is_target = _slot_ids(st, c0)[None, :] == prop_slot[:, None]
    is_ldr = active & is_target & (st.state == LEADER)
    tail = st.last_index - st.commit
    room = (cfg.window // 2 - tail).clamp_min(0)
    cnt = torch.minimum(prop_count[:, None].clamp_max(cfg.max_ents), room)
    cnt = (cnt * is_ldr.to(I32)).to(I32)
    E = cfg.max_ents
    terms = st.term[..., None].expand(*st.term.shape, E)
    st = _write_terms(st, cfg, anchor=st.last_index, terms=terms,
                      lo=st.last_index + 1, count=cnt, mask=cnt > 0)
    st = st._replace(last_index=st.last_index + cnt)
    return _set_self_progress(st, c0)


# ---------------------------------------------------------------------------
# Phase 4: quorum commit
# ---------------------------------------------------------------------------

def _quorum_commit(st: GroupState, cfg: KernelConfig, lead_term0: torch.Tensor,
                   blk: _Blk) -> GroupState:
    G, Pb = st.term.shape
    P = st.match.shape[2]
    eye = _self_eye(st, blk.c0)
    mrow = _where(eye, st.last_index[..., None], st.match)
    mrow = _where(blk.mask[:, None, :], mrow, -1)
    topk = torch.topk(mrow, P, dim=-1, sorted=True).values  # descending
    qidx = (blk.qr - 1)[:, None, None].expand(G, Pb, 1)
    mci = ring_lookup(topk, qidx)[..., 0]
    # Only entries of the leader's own term commit by counting; a leader
    # demoted during the message phase still commits for the term it led
    # at round start (lead_term0).
    eff_term = _where(st.state == LEADER, st.term, lead_term0)
    mci_term = term_at(st, cfg, mci.clamp_min(0))
    ok = (eff_term > 0) & (mci > st.commit) & (mci_term == eff_term)
    return st._replace(commit=_where(ok, mci, st.commit))


# ---------------------------------------------------------------------------
# Phase 5: send assembly (gap-driven)
# ---------------------------------------------------------------------------

def _assemble_sends(st: GroupState, cfg: KernelConfig, resp: torch.Tensor,
                    hb_fire_term: torch.Tensor, vote_fire_term: torch.Tensor,
                    active: torch.Tensor, blk: _Blk, resolve=ring_resolve
                    ) -> Tuple[GroupState, torch.Tensor]:
    """Build the outbox (G, P_from, P_to, F) and apply optimistic progress
    updates for sent appends."""
    G, Pb = st.term.shape
    P = st.match.shape[2]
    F = cfg.fields
    E = cfg.max_ents
    eye = _self_eye(st, blk.c0)
    tgt_ok = blk.mask[:, None, :] & active[:, :, None] & ~eye

    # ---- appends ------------------------------------------------------------
    is_ldr = (st.state == LEADER)[..., None]
    last = st.last_index[..., None]
    unacked = st.next - 1 - st.match
    paused_eff = _where(st.pr_state == PR_PROBE, st.paused,
                        unacked >= cfg.effective_flow_window)
    has_gap = st.next <= last
    prev = st.next - 1
    prev_in_win = in_window(st, cfg, prev)
    # Entries next..next+n-1 must also be resolvable from the sender's
    # ring (prev == 0 passes in_window, but the ring may no longer hold 1).
    ents_ok = st.next > last - cfg.window
    sendable = prev_in_win & ents_ok
    need_snap = is_ldr & tgt_ok & has_gap & ~sendable
    st = st._replace(need_host=_flag(st.need_host, need_snap.any(dim=2),
                                     NH_SNAP))

    send_app = is_ldr & tgt_ok & has_gap & ~paused_eff & sendable
    n = _where(send_app, (last - st.next + 1).clamp_max(E), 0)

    # Entry terms for next .. next+n-1 from the sender's ring.
    arE = _ar(E, st.term)[None, None, None]
    idx_e = st.next[..., None] + arE
    terms_e = ring_lookup(st.log_term[:, :, None, :],
                          torch.remainder(idx_e, cfg.window))
    terms_e = _where(arE < n[..., None], terms_e, 0)

    prev_term = _terms_at_many(st, cfg, prev, resolve)  # (G, P, P)

    out = torch.zeros((G, Pb, P, F), dtype=I32, device=st.term.device)
    term_b = st.term[..., None].expand(G, Pb, P)
    commit_b = st.commit[..., None].expand(G, Pb, P)

    def put(mask, field, val):
        out[..., field] = _where(mask, val, out[..., field])

    put(send_app, F_TYPE, M_APP)
    put(send_app, F_TERM, term_b)
    put(send_app, F_INDEX, prev)
    put(send_app, F_LOGTERM, prev_term)
    put(send_app, F_COMMIT, commit_b)
    put(send_app, F_NENT, n)
    out[..., N_FIXED_FIELDS:] = _where(send_app[..., None], terms_e,
                                       out[..., N_FIXED_FIELDS:])

    # Optimistic update / probe pause.
    st = st._replace(
        next=_where(send_app & (st.pr_state == PR_REPLICATE),
                    st.next + n, st.next),
        paused=_where(send_app & (st.pr_state == PR_PROBE), True, st.paused),
    )

    # ---- heartbeats (lower priority than appends) ---------------------------
    hb_ok = (hb_fire_term[..., None] == term_b) & (hb_fire_term[..., None] > 0)
    send_hb = is_ldr & tgt_ok & hb_ok & ~send_app
    put(send_hb, F_TYPE, M_HB)
    put(send_hb, F_TERM, term_b)
    put(send_hb, F_COMMIT, torch.minimum(st.match, commit_b))

    # ---- vote requests ----------------------------------------------------------
    is_cand = (st.state == CANDIDATE)[..., None]
    vf = ((vote_fire_term[..., None] == term_b)
          & (vote_fire_term[..., None] > 0))
    send_vote = is_cand & tgt_ok & vf & (out[..., F_TYPE] == M_NONE)
    last_t = _last_term(st, cfg)
    put(send_vote, F_TYPE, M_VOTE)
    put(send_vote, F_TERM, term_b)
    put(send_vote, F_INDEX, last.expand(G, Pb, P))
    put(send_vote, F_LOGTERM, last_t[..., None].expand(G, Pb, P))

    # ---- responses override everything (drop-on-collision is safe) ---------
    has_resp = resp[..., F_TYPE] != M_NONE
    return st, _where(has_resp[..., None], resp, out)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def step(cfg: KernelConfig, st: GroupState, inbox: torch.Tensor,
         prop_count: torch.Tensor, prop_slot: torch.Tensor, tick: bool,
         resolve=ring_resolve) -> Tuple[GroupState, torch.Tensor]:
    """One batched consensus round for all G×P instances (full message
    path). inbox (G, P, P_from, F) int32; prop_count, prop_slot (G,)
    int32. Returns (new_state, outbox (G, P_from, P_to, F)).

    Phase order: tick -> messages by sender slot 0..P-1 -> proposals ->
    quorum commit -> send assembly -> invariant check (commit past the
    log end raises NH_VIOLATION)."""
    return _step_body(cfg, st, inbox, prop_count, prop_slot, tick,
                      quiet=False, resolve=resolve)


# ---------------------------------------------------------------------------
# Quiescent fast path: in steady state leaders receive only append /
# heartbeat responses (per-sender columns that commute) and each follower
# receives at most one append-or-heartbeat, from its leader — so the
# message phase collapses into one vectorized pass.
# ---------------------------------------------------------------------------

def _quiet_pred(st: GroupState, cfg: KernelConfig, inbox: torch.Tensor,
                active: torch.Tensor, tick: bool,
                n_lead=None) -> torch.Tensor:
    """() bool tensor: nothing this round can need the sequential message
    phases. Conservative — false negatives only cost a slow round.
    `n_lead` (G,), the leaders of each group over every peer column,
    defaults to the count over this block's columns."""
    mtype = inbox[..., F_TYPE]
    present = mtype != M_NONE
    vote_ish = present & ((mtype == M_VOTE) | (mtype == M_VOTE_RESP))
    term_mism = present & (inbox[..., F_TERM] != st.term[:, :, None])
    is_c = active & (st.state == CANDIDATE)
    could_campaign = (active & (st.state != LEADER)
                      & (st.elapsed + 1 >= cfg.election_tick) & bool(tick))
    if n_lead is None:
        n_lead = (active & (st.state == LEADER)).sum(dim=1, dtype=I32)
    pending_host = st.need_host != 0
    return ~(vote_ish.any() | term_mism.any() | is_c.any()
             | could_campaign.any() | (n_lead > 1).any()
             | pending_host.any())


def _quiet(st: GroupState, cfg: KernelConfig, inbox: torch.Tensor,
           active: torch.Tensor, tick: bool, blk: _Blk) -> bool:
    """The hop's branch, read on the host once. On a block: the leaders of
    each group summed over the peers cells, then one "any" over every
    cell of the mesh, so all blocks take the branch JAX's single
    `lax.cond` takes."""
    if blk.comm is None:
        return bool(_quiet_pred(st, cfg, inbox, active, tick))
    n_lead = blk.comm.sum_peers(
        (active & (st.state == LEADER)).sum(dim=1, dtype=I32))
    return not blk.comm.any(
        ~_quiet_pred(st, cfg, inbox, active, tick, n_lead))


def _quiet_msgs(st: GroupState, cfg: KernelConfig, inbox: torch.Tensor,
                active: torch.Tensor, resolve=ring_resolve
                ) -> Tuple[GroupState, torch.Tensor]:
    """One-pass message processing for quiescent rounds; returns (state,
    resp) with resp shaped (G, P, P, F) like the full path's."""
    G, Pb = st.term.shape
    P = inbox.shape[2]
    F = cfg.fields
    mtype_all = inbox[..., F_TYPE]
    is_l = st.state == LEADER
    recv = active[..., None]

    # -- responses to leaders: all P columns update in one shot.
    mindex_all = inbox[..., F_INDEX]
    mreject_all = inbox[..., F_REJECT]
    mhint_all = inbox[..., F_HINT]
    ar = recv & is_l[..., None] & (mtype_all == M_APP_RESP)
    match, nxt = st.match, st.next
    prs, paused = st.pr_state, st.paused

    rej = ar & (mreject_all != 0)
    repl_rej = rej & (prs == PR_REPLICATE) & (mindex_all > match)
    probe_rej = rej & (prs == PR_PROBE) & (nxt - 1 == mindex_all)
    nxt = _where(repl_rej, match + 1, nxt)
    nxt = _where(probe_rej,
                 torch.minimum(mindex_all, mhint_all + 1).clamp_min(1), nxt)
    prs = _where(repl_rej, PR_PROBE, prs)
    paused = _where(probe_rej, False, paused)

    ok = ar & (mreject_all == 0)
    upd = ok & (match < mindex_all)
    match = _where(upd, mindex_all, match)
    paused = _where(upd, False, paused)
    prs = _where(upd & (prs == PR_PROBE), PR_REPLICATE, prs)
    nxt = torch.maximum(nxt, _where(ok, mindex_all + 1, 0))
    ack_age = _where(ar, 0, st.ack_age)

    hrs = recv & is_l[..., None] & (mtype_all == M_HB_RESP)
    stale = (hrs & (prs == PR_REPLICATE)
             & (match < st.last_index[..., None])
             & (ack_age > 2 * cfg.heartbeat_tick + 2))
    nxt = _where(stale, match + 1, nxt)
    st = st._replace(match=match, next=nxt, pr_state=prs, paused=paused,
                     ack_age=ack_age)

    # -- the one append-or-heartbeat each follower may hold (first sender
    # slot holding one; quiescence allows at most one).
    fm = recv & ~is_l[..., None] & ((mtype_all == M_APP)
                                    | (mtype_all == M_HB))
    has_fm = fm.any(dim=2)
    s_idx = _first_true(fm, dim=2)                              # (G, P)
    onehot_s = _ar(P, st.term)[None, None, :] == s_idx[..., None]
    msg = torch.gather(inbox, 2,
                       s_idx[..., None, None].long().expand(G, Pb, 1, F))
    msg = _where(has_fm[..., None], msg[:, :, 0, :], 0)        # (G, P, F)
    mtype = _where(has_fm, msg[..., F_TYPE], M_NONE)
    mindex = msg[..., F_INDEX]
    mlogterm = msg[..., F_LOGTERM]
    mcommit = msg[..., F_COMMIT]
    mnent = msg[..., F_NENT]
    ent_terms = msg[..., N_FIXED_FIELDS:]

    resp_f = torch.zeros((G, Pb, F), dtype=I32, device=st.term.device)
    a = has_fm & (mtype == M_APP)
    h = has_fm & (mtype == M_HB)
    st = st._replace(
        elapsed=_where(a | h, 0, st.elapsed),
        lead=_where(a | h, s_idx + 1, st.lead),
    )

    below_commit = a & (mindex < st.commit)
    resp_f = _stage(resp_f, below_commit, M_APP_RESP, st.term,
                    index=st.commit)
    chk = a & ~below_commit
    prev_t = term_at(st, cfg, mindex)
    prev_in_win = in_window(st, cfg, mindex)
    escape = chk & ~prev_in_win & (mindex <= st.last_index)
    st = st._replace(need_host=_flag(st.need_host, escape, NH_SNAP))

    match_ok = chk & ~escape & prev_in_win & (prev_t == mlogterm)
    rej_m = chk & ~escape & ~match_ok
    resp_f = _stage(resp_f, rej_m, M_APP_RESP, st.term, index=mindex,
                    reject=True, hint=st.last_index)

    E = cfg.max_ents
    arE = _ar(E, st.term)[None, None]
    idx_j = mindex[..., None] + 1 + arE
    valid_j = arE < mnent[..., None]
    my_t = _terms_at_many(st, cfg, idx_j, resolve)
    mismatch = valid_j & (my_t != ent_terms)
    any_conf = match_ok & mismatch.any(dim=-1)
    first_j = _first_true(mismatch)
    ci = _where(any_conf, mindex + 1 + first_j, 0)
    st = st._replace(need_host=_flag(st.need_host,
                                     any_conf & (ci <= st.commit),
                                     NH_VIOLATION))
    st = _write_terms(st, cfg, anchor=mindex, terms=ent_terms, lo=ci,
                      count=mnent, mask=any_conf)
    lastnewi = mindex + mnent
    st = _truncate_tail(st, cfg, any_conf, lastnewi)
    new_commit = torch.maximum(st.commit, torch.minimum(mcommit, lastnewi))
    st = st._replace(commit=_where(match_ok, new_commit, st.commit))
    resp_f = _stage(resp_f, match_ok, M_APP_RESP, st.term, index=lastnewi)

    st = st._replace(
        commit=_where(h, torch.maximum(st.commit,
                                       torch.minimum(mcommit, st.last_index)),
                      st.commit))
    resp_f = _stage(resp_f, h, M_HB_RESP, st.term)

    # Route each follower's response back to its sender slot.
    resp = resp_f[:, :, None, :] * onehot_s[..., None].to(I32)
    return st, resp


def _step_body(cfg: KernelConfig, st: GroupState, inbox: torch.Tensor,
               prop_count: torch.Tensor, prop_slot: torch.Tensor,
               tick: bool, quiet: bool, force_hb: bool = False,
               resolve=ring_resolve, blk=None
               ) -> Tuple[GroupState, torch.Tensor]:
    """Shared round skeleton; `quiet` selects the message-phase
    implementation. prop_slot=None selects per-slot proposal admission
    (prop_count is then (G, P), the multi-host engine's input).
    `force_hb` makes every active leader broadcast a heartbeat this pass
    (the ReadIndex step's quorum solicitation). `blk` is the block the
    round runs on (default: every column)."""
    if blk is None:
        blk = _block(st, 0, None)
    active = active_mask(st)
    G, Pb = st.term.shape
    P = inbox.shape[2]
    st = st._replace(ack_age=(st.ack_age + 1).clamp_max(1 << 20))
    st, hb_fire, vote_fire = _tick(st, cfg, active, tick, blk)
    if force_hb:
        ldr = active & (st.state == LEADER)
        hb_fire = _where(ldr, st.term, hb_fire)
        # The broadcast resumes paused probes, exactly like a timed one.
        st = st._replace(paused=_where(ldr[..., None], False, st.paused))
    lead_term0 = _where(st.state == LEADER, st.term, 0)
    if quiet:
        st, resp = _quiet_msgs(st, cfg, inbox, active, resolve)
    else:
        resp = torch.zeros((G, Pb, P, cfg.fields), dtype=I32,
                           device=st.term.device)
        for q in range(P):
            st, r = _step_msgs_from(st, cfg, q, inbox[:, :, q, :], active,
                                    blk, resolve)
            resp[:, :, q, :] = r
    if prop_slot is None:
        st = _apply_proposals_slots(st, cfg, prop_count, active, blk.c0)
    else:
        st = _apply_proposals(st, cfg, prop_count, prop_slot, active,
                              blk.c0)
    st = _quorum_commit(st, cfg, lead_term0, blk)
    st, outbox = _assemble_sends(st, cfg, resp, hb_fire, vote_fire, active,
                                 blk, resolve)
    bad = active & (st.commit > st.last_index)
    st = st._replace(need_host=_flag(st.need_host, bad, NH_VIOLATION))
    return st, outbox


def _hop(cfg: KernelConfig, st: GroupState, inbox: torch.Tensor,
         prop_count: torch.Tensor, prop_slot: torch.Tensor, tick: bool,
         force_hb: bool, resolve, blk: _Blk
         ) -> Tuple[GroupState, torch.Tensor]:
    """One message-phase+routing pass with the fast path selected by one
    host read of the quiescence predicate (exactly one branch runs)."""
    quiet = _quiet(st, cfg, inbox, active_mask(st), tick, blk)
    s, out = _step_body(cfg, st, inbox, prop_count, prop_slot, tick,
                        quiet=quiet, force_hb=force_hb, resolve=resolve,
                        blk=blk)
    if blk.comm is None:
        return s, route_local(out)
    return s, route_block(out, blk.comm)


def step_routed_auto(cfg: KernelConfig, st: GroupState, inbox: torch.Tensor,
                     prop_count: torch.Tensor, prop_slot: torch.Tensor,
                     tick: bool, drop_mask=None, hops: int = 1,
                     resolve=ring_resolve, c0: int = 0,
                     comm=None) -> Tuple[GroupState, torch.Tensor]:
    """step + route_local with fast-path selection per hop. `hops` chains
    that many message-phase+routing passes: proposals and the tick fire
    only on the first hop, so `hops=H` equals H successive 1-hop calls
    whose last H-1 carry no proposals and no tick. `drop_mask`
    (G, P_to, P_from, 1) int32 is applied to the routed inbox after every
    hop (fault injection).

    On a block (`c0`, `comm`; see the module docstring) st holds peer
    columns [c0, c0 + Pb) of a block of groups, inbox is (Gb, Pb, P, F),
    prop_count/prop_slot are the block's groups and drop_mask its
    (Gb, Pb, P, 1) slice; the result is the block of the unsharded
    round's result."""
    blk = _block(st, c0, comm)
    zero = torch.zeros_like(prop_count)
    for h in range(hops):
        st, inbox = _hop(cfg, st, inbox, prop_count if h == 0 else zero,
                         prop_slot, bool(tick) and h == 0, False, resolve,
                         blk)
        if drop_mask is not None:
            inbox = inbox * drop_mask
    return st, inbox


def route_local(outbox: torch.Tensor) -> torch.Tensor:
    """Single-host message routing: outbox[g, from, to] -> inbox[g, to,
    from], a transpose of the peer axes (materialized contiguous)."""
    return outbox.transpose(1, 2).contiguous()


def route_block(outbox: torch.Tensor, comm) -> torch.Tensor:
    """route_local across the peers cells: this block's outbox
    (G, Pb_from, P_to, F) goes out as one chunk per receiving cell j
    (its Pb target columns), laid out (Pc, G, Pb_from, Pb_to, F) for one
    all-to-all; the chunks received from every cell j form the inbox
    (G, Pb_to, P_from, F) with sender column j * Pb + f."""
    G, Pb, P, F = outbox.shape
    Pc = comm.peers
    send = outbox.reshape(G, Pb, Pc, Pb, F).permute(2, 0, 1, 3, 4)
    recv = comm.all_to_all(send.contiguous())     # (Pc, G, Pb_f, Pb_t, F)
    return recv.permute(1, 3, 0, 2, 4).reshape(G, Pb, Pc * Pb, F)


def step_routed(cfg: KernelConfig, st: GroupState, inbox: torch.Tensor,
                prop_count: torch.Tensor, prop_slot: torch.Tensor,
                tick: bool, resolve=ring_resolve
                ) -> Tuple[GroupState, torch.Tensor]:
    """step + route_local: returns (new_state, next_inbox)."""
    st, outbox = step(cfg, st, inbox, prop_count, prop_slot, tick, resolve)
    return st, route_local(outbox)


# ---------------------------------------------------------------------------
# Batched ReadIndex (the zero-append linearizable read plane)
# ---------------------------------------------------------------------------

def _at_slot(x: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """x[g, slot[g]] for x (G, P), slot (G,)."""
    return torch.gather(x, 1, slot[:, None].long())[:, 0]


def _read_register(st: GroupState, cfg: KernelConfig, blk: _Blk):
    """Register a batched ReadIndex for every group: (read_slot,
    read_term, read_commit, has_ldr), all (G,). has_ldr also requires the
    leader to have committed an entry of its own term. On a block the
    three columns it needs are gathered from every peers cell first, so
    the argmax's ties break to the first slot, as in JAX."""
    lead_term = _where(active_mask(st) & (st.state == LEADER), st.term, 0)
    commit = st.commit
    commit_term = term_at(st, cfg, st.commit)
    if blk.comm is not None:
        cols = blk.comm.gather_peers(
            torch.stack([lead_term, commit, commit_term], dim=2))
        lead_term, commit, commit_term = cols.unbind(2)
    read_term = lead_term.amax(dim=1)
    read_slot = _first_true(lead_term == read_term[:, None], dim=1)
    read_commit = _at_slot(commit, read_slot)
    commit_term = _at_slot(commit_term, read_slot)
    has_ldr = (read_term > 0) & (commit_term == read_term)
    return read_slot, read_term, read_commit, has_ldr


def step_routed_read_auto(cfg: KernelConfig, st: GroupState,
                          inbox: torch.Tensor, prop_count: torch.Tensor,
                          prop_slot: torch.Tensor, tick: bool,
                          drop_mask=None, hops: int = 1,
                          resolve=ring_resolve, c0: int = 0, comm=None):
    """step_routed_auto plus a batched ReadIndex pass: returns (st, inbox,
    confirmed (G,) bool, read_commit (G,) int32).

    Each group's leader registers the read at invocation start, hop 0
    forces a heartbeat broadcast, and every hop counts the heartbeat /
    append responses routed back to the leader slot at the registered
    term. Only messages produced inside this invocation are counted.

    On a block (see step_routed_auto) the block holding the leader's row
    counts its acks; the counts and the leader's standing are summed over
    the peers cells, so every cell returns the same (Gb,) results."""
    G, Pb = st.term.shape
    P = inbox.shape[2]
    blk = _block(st, c0, comm)
    read_slot, read_term, read_commit, has_ldr = _read_register(st, cfg,
                                                                blk)
    local = read_slot - c0
    owns = (local >= 0) & (local < Pb)           # the leader's row is here
    lrow = local.clamp(0, Pb - 1)
    oh_lead = _ar(P, st.term)[None, :] == read_slot[:, None]   # (G, P_from)
    acks = torch.zeros((G, P), dtype=torch.bool, device=st.term.device)
    zero = torch.zeros_like(prop_count)
    rows = torch.arange(G, device=st.term.device)
    for h in range(hops):
        st, inbox = _hop(cfg, st, inbox, prop_count if h == 0 else zero,
                         prop_slot, bool(tick) and h == 0, h == 0, resolve,
                         blk)
        if drop_mask is not None:
            inbox = inbox * drop_mask
        to_lead = inbox[rows, lrow.long()]                 # (G, P_from, F)
        mt = to_lead[..., F_TYPE]
        fresh = (((mt == M_HB_RESP) | (mt == M_APP_RESP))
                 & (to_lead[..., F_TERM] == read_term[:, None]))
        acks = acks | (fresh & owns[:, None])
    n_acks = (acks & ~oh_lead).sum(dim=1, dtype=I32)
    still = (owns & (_at_slot(st.state, lrow) == LEADER)
             & (_at_slot(st.term, lrow) == read_term))
    if comm is not None:
        tally = comm.sum_peers(torch.stack([n_acks, still.to(I32)], dim=1))
        n_acks, still = tally[:, 0], tally[:, 1] > 0
    confirmed = has_ldr & still & (n_acks + 1 >= blk.qr)
    return st, inbox, confirmed, read_commit


# Per-(g, p) change flags emitted by step_routed_compact.
CHG_HS = 1       # term | vote | commit changed (the WAL HardState diff)
CHG_LAST = 2     # last_index changed
CHG_RING = 4     # any ring (log-term window) slot changed
CHG_STATE = 8    # role changed (host mirror only; never journaled)


def step_routed_compact(cfg: KernelConfig, st: GroupState,
                        inbox: torch.Tensor, prop_count: torch.Tensor,
                        prop_slot: torch.Tensor, tick: bool,
                        drop_mask=None, hops: int = 1,
                        resolve=ring_resolve):
    """step_routed_auto plus an on-device state diff: returns (st, inbox,
    flags (G, P) uint8 CHG_* bitmask vs the pre-step state, any_need_host
    () bool). The host then reads back only the changed rows
    (gather_rows)."""
    st0 = st
    st, inbox = step_routed_auto(cfg, st, inbox, prop_count, prop_slot,
                                 tick, drop_mask, hops, resolve)
    u8 = torch.uint8
    hs = ((st.term != st0.term) | (st.vote != st0.vote)
          | (st.commit != st0.commit))
    flags = (hs.to(u8) * CHG_HS
             | (st.last_index != st0.last_index).to(u8) * CHG_LAST
             | (st.log_term != st0.log_term).any(dim=2).to(u8) * CHG_RING
             | (st.state != st0.state).to(u8) * CHG_STATE)
    any_nh = (st.need_host != 0).any()
    return st, inbox, flags, any_nh


def gather_rows(st: GroupState, gi: torch.Tensor, pi: torch.Tensor):
    """The engine-mirrored fields for K (g, p) rows: (term, vote, commit,
    state, last_index) each (K,) plus the (K, W) ring rows."""
    gi, pi = gi.long(), pi.long()
    return (st.term[gi, pi], st.vote[gi, pi], st.commit[gi, pi],
            st.state[gi, pi], st.last_index[gi, pi], st.log_term[gi, pi])


def step_routed_slots(cfg: KernelConfig, st: GroupState,
                      inbox: torch.Tensor, cnt_gp: torch.Tensor, tick: bool,
                      resolve=ring_resolve
                      ) -> Tuple[GroupState, torch.Tensor]:
    """Multi-host serving step: per-slot proposal counts cnt_gp (G, P)
    (see _apply_proposals_slots), full sequential message path, local
    routing."""
    st, outbox = _step_body(cfg, st, inbox, cnt_gp, None, tick,
                            quiet=False, resolve=resolve)
    return st, route_local(outbox)


def step_routed_slots_auto(cfg: KernelConfig, st: GroupState,
                           inbox: torch.Tensor, cnt_gp: torch.Tensor,
                           tick: bool, drop_mask=None, hops: int = 1,
                           resolve=ring_resolve, c0: int = 0, comm=None
                           ) -> Tuple[GroupState, torch.Tensor]:
    """step_routed_slots with the quiescent fast path and the same
    multi-hop/drop-mask machinery as step_routed_auto (this is that
    function with per-slot admission, prop_slot=None).

    Durability constraint for multi-host callers: hops must stay 1 when
    peers live on independently failing hosts. With hops>1 the leader
    counts follower acks produced on the device before those followers'
    hosts journaled the entries, so a follower-host crash could lose an
    acked write.

    On a block (see step_routed_auto) cnt_gp is the block's (Gb, Pb)."""
    return step_routed_auto(cfg, st, inbox, cnt_gp, None, tick, drop_mask,
                            hops, resolve, c0, comm)


_STEPS = {
    "step_routed_auto": step_routed_auto,
    "step_routed_compact": step_routed_compact,
    "step_routed_read_auto": step_routed_read_auto,
    "step_routed_slots_auto": step_routed_slots_auto,
}


def step_variant(name: str):
    """The round function `name` (kept for parity with the JAX package,
    whose version picks a jit twin; PyTorch runs eagerly)."""
    return _STEPS[name]

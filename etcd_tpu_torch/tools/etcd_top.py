#!/usr/bin/env python
"""etcd_top: a live terminal dashboard over the engine's /metrics.

Polls one Prometheus text endpoint (the engine front's /metrics, or the
pool router's) and renders a compact per-compartment view every interval:

    round loop   rounds/s, batch p50/p99, phase p99s (stage/dispatch/
                 readback/record/wal_submit/tail), kernel step p99
    wal writer   per-shard fsync p50/p99, group-commit size, queue
                 depth, watermark lag
    appliers     per-shard queue depth, apply-batch p99, ack-gate p99
    proposals    reference etcd_server_proposal_* (rate, pending, failed)

Rates and quantiles are computed client-side from two consecutive
scrapes (histograms are cumulative; the delta between scrapes is the
interval's distribution). Quantiles are bucket upper bounds — the same
estimate `histogram_quantile()` gives.

Usage:
    python scripts/etcd_top.py http://127.0.0.1:2379 [--interval 2] [-n N]

`--once` (or -n) renders N frames then exits (testable / scriptable);
default runs until Ctrl-C. No dependencies beyond the stdlib.
"""
import argparse
import sys
import time
import urllib.request


# -- scrape + parse ----------------------------------------------------------

def parse_metrics(text):
    """Prometheus text format -> {(name, ((label, value), ...)): float}.

    Handles escaped label values (\\\\, \\", \\n) and ignores comments
    and malformed lines (a scrape mid-restart should degrade, not
    crash the dashboard)."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name, labels, val = _parse_line(line)
        except ValueError:
            continue
        out[(name, labels)] = val
    return out


def _parse_line(line):
    if "{" in line:
        name, rest = line.split("{", 1)
        lab_s, _, val_s = rest.rpartition("}")
        labels = tuple(sorted(_parse_labels(lab_s).items()))
    else:
        name, _, val_s = line.partition(" ")
        labels = ()
    return name, labels, float(val_s.strip())


def _parse_labels(s):
    """label="value" pairs with text-format unescaping."""
    labels = {}
    i = 0
    while i < len(s):
        eq = s.index("=", i)
        key = s[i:eq].strip().lstrip(",").strip()
        i = eq + 1
        if s[i] != '"':
            raise ValueError("unquoted label value")
        i += 1
        buf = []
        while s[i] != '"':
            c = s[i]
            if c == "\\":
                i += 1
                c = {"n": "\n", '"': '"', "\\": "\\"}.get(s[i], s[i])
            buf.append(c)
            i += 1
        labels[key] = "".join(buf)
        i += 1
    return labels


def scrape(url, timeout=5.0):
    with urllib.request.urlopen(url.rstrip("/") + "/metrics",
                                timeout=timeout) as r:
        return parse_metrics(r.read().decode())


# -- client-side histogram math ----------------------------------------------

def hist_delta(prev, cur, name, match=()):
    """Per-interval bucket counts for one histogram series: sorted
    [(le_float, delta_count)], total delta count, and delta sum."""
    buckets = []
    total = dsum = 0.0
    for (n, labels), v in cur.items():
        lab = dict(labels)
        if any(lab.get(k) != w for k, w in match):
            continue
        base = prev.get((n, labels), 0.0)
        if n == name + "_bucket":
            le = lab.get("le", "+Inf")
            buckets.append((float("inf") if le == "+Inf" else float(le),
                            v - base))
        elif n == name + "_count":
            total = v - base
        elif n == name + "_sum":
            dsum = v - base
    buckets.sort(key=lambda b: b[0])
    return buckets, total, dsum


def quantile(buckets, total, q):
    """Bucket-upper-bound quantile over cumulative per-interval buckets
    (the histogram_quantile estimate, without intra-bucket
    interpolation for the finite buckets)."""
    if total <= 0:
        return None
    rank = q * total
    for le, cum in buckets:
        if cum >= rank:
            return le
    return buckets[-1][0] if buckets else None


def counter_rate(prev, cur, name, dt, match=()):
    d = 0.0
    for (n, labels), v in cur.items():
        if n != name:
            continue
        lab = dict(labels)
        if any(lab.get(k) != w for k, w in match):
            continue
        d += v - prev.get((n, labels), 0.0)
    return d / dt if dt > 0 else 0.0


def gauge(cur, name, match=()):
    for (n, labels), v in cur.items():
        if n != name:
            continue
        lab = dict(labels)
        if any(lab.get(k) != w for k, w in match):
            continue
        return v
    return None


def label_values(cur, name, key):
    vals = set()
    for (n, labels), _v in cur.items():
        if n.startswith(name):
            lab = dict(labels)
            if key in lab:
                vals.add(lab[key])
    return sorted(vals, key=lambda s: (len(s), s))


# -- rendering ---------------------------------------------------------------

def _ms(seconds):
    if seconds is None:
        return "    -"
    return f"{seconds * 1e3:8.2f}ms"


def _q(prev, cur, name, qv, match=()):
    b, t, _ = hist_delta(prev, cur, name, match)
    return quantile(b, t, qv)


def render(prev, cur, dt):
    """One dashboard frame (list of lines) from two scrapes."""
    L = []
    rps = counter_rate(prev, cur, "etcd_engine_rounds_total", dt)
    aps = counter_rate(prev, cur, "etcd_engine_acked_requests_total", dt)
    pps = counter_rate(
        prev, cur, "etcd_server_proposal_durations_milliseconds_count", dt)
    pend = gauge(cur, "etcd_server_proposal_pending")
    failed = gauge(cur, "etcd_server_proposal_failed_total")
    L.append(f"rounds/s {rps:8.1f}   acked/s {aps:8.1f}   "
             f"proposals/s {pps:8.1f}   pending {pend or 0:4.0f}   "
             f"failed {failed or 0:6.0f}")

    L.append("round loop        p50        p99")
    for ph in ("stage", "dispatch", "readback", "record", "wal_submit",
               "tail"):
        m = (("phase", ph),)
        L.append(f"  {ph:<12}{_ms(_q(prev, cur, 'etcd_engine_round_phase_seconds', 0.5, m))}"
                 f" {_ms(_q(prev, cur, 'etcd_engine_round_phase_seconds', 0.99, m))}")
    L.append(f"  {'kernel step':<12}"
             f"{_ms(_q(prev, cur, 'etcd_engine_kernel_step_seconds', 0.5))}"
             f" {_ms(_q(prev, cur, 'etcd_engine_kernel_step_seconds', 0.99))}")
    bq = _q(prev, cur, "etcd_engine_round_batch_requests", 0.99)
    L.append(f"  batch p99   {bq if bq is not None else '-':>10}")

    lag = gauge(cur, "etcd_wal_writer_watermark_lag_tickets")
    L.append(f"wal writer (watermark lag {lag if lag is not None else '-'})"
             f"   fsync p50   fsync p99   commit p99   queue")
    for sh in label_values(cur, "etcd_wal_writer_fsync_seconds", "shard"):
        m = (("shard", sh),)
        cm = _q(prev, cur, "etcd_wal_writer_group_commit_rounds", 0.99, m)
        qd = gauge(cur, "etcd_wal_writer_queue_depth", m)
        L.append(f"  shard {sh:<4}"
                 f"{_ms(_q(prev, cur, 'etcd_wal_writer_fsync_seconds', 0.5, m))}  "
                 f"{_ms(_q(prev, cur, 'etcd_wal_writer_fsync_seconds', 0.99, m))}  "
                 f"{cm if cm is not None else '-':>9}   "
                 f"{qd if qd is not None else '-':>5}")

    L.append("appliers    batch p99    queue    ack-gate p99 "
             f"{_ms(_q(prev, cur, 'etcd_ack_gate_wait_seconds', 0.99))}")
    for sh in label_values(cur, "etcd_applier_apply_batch_requests",
                           "shard"):
        m = (("shard", sh),)
        ab = _q(prev, cur, "etcd_applier_apply_batch_requests", 0.99, m)
        qd = gauge(cur, "etcd_applier_queue_depth", m)
        L.append(f"  shard {sh:<4}{ab if ab is not None else '-':>9}"
                 f"    {qd if qd is not None else '-':>5}")

    # The read plane: quorum reads are NOT proposals (zero-append
    # ReadIndex path) — their rate/latency/parking meter here.
    rdps = counter_rate(prev, cur, "etcd_read_index_reads_total", dt)
    parked = gauge(cur, "etcd_read_index_parked_reads")
    rfailed = gauge(cur, "etcd_read_index_failed_total")
    leased = counter_rate(prev, cur, "etcd_read_index_lease_reads_total",
                          dt)
    cq = _q(prev, cur, "etcd_read_index_confirmations_per_round", 0.99)
    L.append(f"read plane  reads/s {rdps:8.1f}   parked "
             f"{parked or 0:5.0f}   lease/s {leased:7.1f}   failed "
             f"{rfailed or 0:6.0f}   confirms/round p99 "
             f"{cq if cq is not None else '-'}")
    # Quantiles of the summary ride the scrape directly (server-side
    # sliding window, milliseconds).
    p50 = gauge(cur, "etcd_read_index_durations_milliseconds",
                (("quantile", "0.5"),))
    p99 = gauge(cur, "etcd_read_index_durations_milliseconds",
                (("quantile", "0.99"),))
    L.append(f"  read latency p50 "
             f"{'-' if p50 is None else f'{p50:8.2f}ms'}   p99 "
             f"{'-' if p99 is None else f'{p99:8.2f}ms'}")

    rt = label_values(cur, "etcd_pool_router_requests_total", "shard")
    if rt:
        parts = []
        for sh in rt:
            r = counter_rate(prev, cur, "etcd_pool_router_requests_total",
                             dt, (("shard", sh),))
            parts.append(f"{sh}:{r:.1f}/s")
        L.append("router      " + "  ".join(parts))

    # The ingress tier (point etcd_top at an ingress process's
    # /metrics): coalescing window shape, upstream pressure, hub fan-out.
    if gauge(cur, "etcd_ingress_coalesce_batch_requests_count") is not None:
        iaps = counter_rate(prev, cur, "etcd_ingress_acked_requests_total",
                            dt)
        ierr = counter_rate(prev, cur,
                            "etcd_ingress_upstream_errors_total", dt)
        infl = gauge(cur, "etcd_ingress_upstream_inflight_batches")
        bq = _q(prev, cur, "etcd_ingress_coalesce_batch_requests", 0.99)
        ilease = counter_rate(prev, cur,
                              "etcd_ingress_lease_reads_total", dt)
        L.append(f"ingress     acked/s {iaps:8.1f}   errors/s "
                 f"{ierr:6.1f}   inflight {infl or 0:3.0f}   batch p99 "
                 f"{bq if bq is not None else '-':>6}   lease/s "
                 f"{ilease:7.1f}")
        reasons = []
        for rsn in label_values(cur, "etcd_ingress_flush_reason_total",
                                "reason"):
            r = counter_rate(prev, cur, "etcd_ingress_flush_reason_total",
                             dt, (("reason", rsn),))
            reasons.append(f"{rsn}:{r:.1f}/s")
        a50 = gauge(cur, "etcd_ingress_ack_milliseconds",
                    (("quantile", "0.5"),))
        a99 = gauge(cur, "etcd_ingress_ack_milliseconds",
                    (("quantile", "0.99"),))
        L.append(f"  flush {'  '.join(reasons) or '-'}   ack p50 "
                 f"{'-' if a50 is None else f'{a50:7.2f}ms'}   p99 "
                 f"{'-' if a99 is None else f'{a99:7.2f}ms'}")
        hw = gauge(cur, "etcd_ingress_hub_watchers")
        hs = gauge(cur, "etcd_ingress_hub_streams")
        hd = counter_rate(prev, cur, "etcd_ingress_hub_deliveries_total",
                          dt)
        L.append(f"  hub watchers {hw or 0:6.0f}   upstream streams "
                 f"{hs or 0:4.0f}   deliveries/s {hd:8.1f}")
        # Round-11 pipelined channel + native hot loop: frame flow on
        # the persistent upstream, its failure counters, and which
        # codec the hot loop is running.
        fsent = counter_rate(prev, cur,
                             "etcd_ingress_upstream_frames_total", dt,
                             (("direction", "sent"),))
        frecv = counter_rate(prev, cur,
                             "etcd_ingress_upstream_frames_total", dt,
                             (("direction", "recv"),))
        recon = gauge(cur, "etcd_ingress_upstream_reconnects_total")
        sever = gauge(cur, "etcd_ingress_upstream_severed_flushes_total")
        fall = gauge(cur, "etcd_ingress_upstream_fallbacks_total")
        nat = gauge(cur, "etcd_ingress_native_enabled")
        L.append(f"  upstream frames/s sent {fsent:7.1f} recv "
                 f"{frecv:7.1f}   reconnects {recon or 0:4.0f}   "
                 f"severed {sever or 0:5.0f}   fallbacks "
                 f"{fall or 0:3.0f}   native "
                 f"{'-' if nat is None else ('on' if nat else 'off')}")
    return L


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("url", help="base URL serving /metrics")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("-n", "--frames", type=int, default=0,
                    help="render N frames then exit (0 = forever)")
    args = ap.parse_args()

    prev, t_prev = scrape(args.url), time.time()
    n = 0
    try:
        while True:
            time.sleep(args.interval)
            cur, t_cur = scrape(args.url), time.time()
            frame = render(prev, cur, t_cur - t_prev)
            sys.stdout.write("\x1b[2J\x1b[H" if args.frames == 0 else "")
            sys.stdout.write(
                f"etcd_top  {args.url}  {time.strftime('%H:%M:%S')}\n"
                + "\n".join(frame) + "\n")
            sys.stdout.flush()
            prev, t_prev = cur, t_cur
            n += 1
            if args.frames and n >= args.frames:
                return 0
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's C codecs (etcd_tpu_torch/native/{walcodec,ingresscore}.c,
built at first use) against its Python fallbacks and the JAX package's
Python fallbacks (etcd_tpu.native._py_*): the nine tests of
tests/test_native.py, each corpus run three ways and required
byte-identical. Corpora are seeded with numpy: framed, chain-CRC'd
records; torn tails and flipped bits; pack_multi against both engines'
packing; pipelined HTTP requests with every error code; formatted
responses. Tolerance: exact."""
import io
import os
from http.client import HTTPResponse

import numpy as np
import pytest

from etcd_tpu import native as jnative
from etcd_tpu.server import engine as jax_engine
from etcd_tpu_torch import native
from etcd_tpu_torch.server import engine as torch_engine

SEEDS = (0, 1, 0xDEADBEEF)


def _records(seed, n=40):
    """Seeded (type, payload) records: empty, short and 10 KB payloads."""
    rng = np.random.default_rng(seed)
    out = [(2, b"hello"), (3, b""), (2, b"x" * 10000),
           (7, bytes(range(256)))]
    for _ in range(n):
        ln = int(rng.choice([0, 1, 17, 300, 4096]))
        out.append((int(rng.integers(0, 2 ** 32)),
                    rng.integers(0, 256, ln, dtype=np.uint8).tobytes()))
    return out


def _three(fn_c, fn_port_py, fn_jax_py, *args):
    """The C result, after asserting all three implementations agree."""
    c, p, j = fn_c(*args), fn_port_py(*args), fn_jax_py(*args)
    assert c == p == j
    return c


def test_the_c_is_loaded():
    """The wrappers run the port's own libraries, built at first use."""
    import sys
    assert native.HAVE_NATIVE and native.HAVE_NATIVE_INGRESS
    assert native._c_pack_multi is not None
    for name in ("walcodec", "ingresscore"):
        path = sys.modules[f"etcd_tpu_torch.native.{name}"].__file__
        assert os.path.dirname(path) == os.path.dirname(native.__file__)


def test_python_roundtrip():
    recs = _records(7)
    buf, crc = native._py_encode_records(recs, 123)
    got, crc2, consumed = native._py_scan_records(buf, 123)
    assert got == recs and crc2 == crc and consumed == len(buf)
    assert (buf, crc) == jnative._py_encode_records(recs, 123)


@pytest.mark.parametrize("seed", SEEDS)
def test_native_matches_python_bytes(seed):
    recs = _records(seed)
    crc0 = seed & 0xFFFFFFFF
    _three(native._c_encode, native._py_encode_records,
           jnative._py_encode_records, recs, crc0)
    assert native.encode_records(recs, crc0) == \
        jnative._py_encode_records(recs, crc0)


@pytest.mark.parametrize("seed", SEEDS)
def test_native_scan_matches_python(seed):
    rng = np.random.default_rng(seed)
    recs = _records(seed, n=12)
    buf, _ = jnative._py_encode_records(recs, 5)
    cases = [buf, buf[:-3], buf[:20] + b"\xff" + buf[21:], b""]
    for _ in range(8):    # seeded torn tails and flipped bits
        cut = int(rng.integers(0, len(buf)))
        cases.append(buf[:cut])
        pos = int(rng.integers(0, len(buf)))
        bit = 1 << int(rng.integers(0, 8))
        cases.append(buf[:pos] + bytes([buf[pos] ^ bit]) + buf[pos + 1:])
    for data in cases:
        _three(native._c_scan, native._py_scan_records,
               jnative._py_scan_records, data, 5)


def test_scan_stops_at_flip_keeps_prefix():
    recs = _records(9, n=0)
    buf, _ = native.encode_records(recs, 9)
    off = sum(16 + len(p) for _, p in recs[:2]) + 20
    bad = buf[:off] + bytes([buf[off] ^ 0xFF]) + buf[off + 1:]
    got, _, consumed = _three(native._c_scan, native._py_scan_records,
                              jnative._py_scan_records, bad, 9)
    assert got == recs[:2]
    assert consumed == sum(16 + len(p) for _, p in recs[:2])


def test_enginewal_replay_uses_codec(tmp_path):
    """The port's EngineWAL on the C codec writes the JAX EngineWAL's
    bytes (Python codec), replays them, and cuts a torn tail alike."""
    from etcd_tpu.server.enginewal import EngineWAL as JWAL
    from etcd_tpu.server.enginewal import RoundRecord as JRec
    from etcd_tpu_torch.server.enginewal import EngineWAL, RoundRecord
    for mod_wal, mod_rec, d in ((EngineWAL, RoundRecord, "port"),
                                (JWAL, JRec, "jax")):
        w = mod_wal(str(tmp_path / d), fsync=False)
        for i in range(5):
            w.append(mod_rec(round_no=i,
                             entries=[(0, i + 1, 1, b"payload%d" % i)]))
        w.close()
    segs = {d: sorted(n for n in os.listdir(tmp_path / d)
                      if n.endswith(".wal")) for d in ("port", "jax")}
    assert segs["port"] == segs["jax"] and len(segs["port"]) == 1
    seg = segs["port"][0]
    port_seg, jax_seg = tmp_path / "port" / seg, tmp_path / "jax" / seg
    assert port_seg.read_bytes() == jax_seg.read_bytes()
    got = list(EngineWAL(str(tmp_path / "port"), fsync=False).replay())
    assert [r.round_no for r in got] == list(range(5))
    assert got[3].entries == [(0, 4, 1, b"payload3")]
    port_seg.write_bytes(port_seg.read_bytes()[:-7])
    got = list(EngineWAL(str(tmp_path / "port"), fsync=False).replay())
    assert [r.round_no for r in got] == list(range(4))


def test_pack_multi_byte_identical(monkeypatch):
    """walcodec.pack_multi equals the Python packing of both packages'
    engines (`_pack_entry`'s multi branch) and of the port's native
    wrapper's fallback; it refuses what the JAX C refuses."""
    from etcd_tpu_torch.native.walcodec import pack_multi
    P_MULTI = torch_engine.P_MULTI
    assert P_MULTI == jax_engine.P_MULTI
    rng = np.random.default_rng(11)
    cases = [
        [(1, b"\x00" + b'{"id":1}')],
        [(1, b"\x00" + b'{"id":1}'), (2, b"\x00" + b'{"id":2,"v":"x"}')],
        [(i, b"\x00" + bytes([65 + (i % 26)]) * (i % 300 + 1), None)
         for i in range(512)],
        [(7, b"\x01")],
        [(i, rng.integers(0, 256, int(rng.integers(1, 200)),
                          dtype=np.uint8).tobytes()) for i in range(64)],
    ]
    for mod in (native, torch_engine, jax_engine):
        monkeypatch.setattr(mod, "_c_pack_multi", None)   # Python packing
    for items in cases:
        c = pack_multi(items, P_MULTI)
        assert c == native.pack_multi(items, P_MULTI) == \
            jnative.pack_multi(items, P_MULTI)
        if len(items) > 1:
            assert c == torch_engine._pack_entry(items) == \
                jax_engine._pack_entry(items)
    with pytest.raises(TypeError):
        pack_multi([(1, "not-bytes")], P_MULTI)
    with pytest.raises(TypeError):
        pack_multi([(1, b"")], P_MULTI)
    with pytest.raises(TypeError):
        pack_multi([1], P_MULTI)


def _scan_cases(seed):
    """tests/test_native.py's request corpus, plus seeded pipelines of
    complete and cut-off requests."""
    cases = [
        b"",
        b"GET /health HTTP/1.1\r\n\r\n",
        (b"PUT /tenants/1/v2/keys/a?x=1 HTTP/1.1\r\n"
         b"Content-Length: 5\r\n"
         b"Content-Type: application/x-www-form-urlencoded\r\n"
         b"Authorization: Basic abc=\r\nConnection: close\r\n\r\nvalue"),
        b"PUT /a HTTP/1.1\r\nContent-Length: 5\r\n\r\nvalueP"
        b"UT /b HTTP/1.1\r\nContent-Length: 5\r\n\r\nva",
        b"GET /a HTTP/1.1\r\n\r\nGET /b HTTP/1.1\r\nconnection: CLOSE\r\n\r\n",
        b"BADLINE\r\n\r\n",
        b"GET /a HTTP/1.1\r\nContent-Length: zz\r\n\r\n",
        b"GET /a HTTP/1.1\r\nContent-Length: 99999999999\r\n\r\n",
        b"GET /a HTTP/1.1\r\nContent-Length:\r\n\r\n",
        b"X" * (65 * 1024),
        b"GET /a HTTP/1.1\r\nNo-colon-line junk\r\nAuthorization:  pad  "
        b"\r\n\r\n",
    ]
    rng = np.random.default_rng(seed)
    for _ in range(6):
        reqs = []
        for _ in range(int(rng.integers(1, 200))):
            body = rng.integers(97, 123, int(rng.integers(0, 64)),
                                dtype=np.uint8).tobytes()
            reqs.append(b"PUT /tenants/%d/v2/keys/k%d HTTP/1.1\r\n"
                        b"Content-Length: %d\r\n\r\n%s"
                        % (int(rng.integers(0, 10 ** 5)),
                           int(rng.integers(0, 99)), len(body), body))
        blob = b"".join(reqs)
        cases += [blob, blob[:int(rng.integers(0, len(blob)))]]
    return cases


def test_py_scan_requests_semantics():
    for py in (native._py_scan_requests, jnative._py_scan_requests):
        case = _scan_cases(0)[2]
        reqs, consumed, err = py(case)
        assert err == native.ING_OK and consumed == len(case)
        m, t, ctype, auth, close, body = reqs[0]
        assert (m, t) == ("PUT", "/tenants/1/v2/keys/a?x=1")
        assert ctype.startswith("application/x-www-form")
        assert auth == "Basic abc=" and close and body == b"value"
        reqs, consumed, err = py(_scan_cases(0)[5])
        assert err == native.ING_EBADLINE and reqs == [] and consumed == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_native_scan_requests_matches_python(seed):
    errs = set()
    for case in _scan_cases(seed):
        got = _three(native._c_scan_requests, native._py_scan_requests,
                     jnative._py_scan_requests, bytes(case))
        errs.add(got[2])
    assert errs == {native.ING_OK, native.ING_EBADLINE, native.ING_EBADLEN,
                    native.ING_EBODY, native.ING_EHEADERS}
    case = _scan_cases(seed)[4]
    assert native.scan_requests(bytearray(case)) == \
        jnative._py_scan_requests(case)


class _FakeSock:
    def __init__(self, data):
        self._f = io.BytesIO(data)

    def makefile(self, *a, **k):
        return self._f


@pytest.mark.parametrize("seed", SEEDS)
def test_native_format_responses_matches_python(seed):
    rng = np.random.default_rng(seed)
    items = [(200, b'{"ok":1}\n'), (201, b""), (503, b"{}"),
             (412, b"precondition"), (777, b"unknown-status")]
    statuses = [200, 201, 400, 401, 403, 404, 405, 408, 412, 500, 503, 299]
    items += [(int(rng.choice(statuses)),
               rng.integers(32, 127, int(rng.integers(0, 500)),
                            dtype=np.uint8).tobytes()) for _ in range(50)]
    c = _three(native._c_format_responses, native._py_format_responses,
               jnative._py_format_responses, items)
    r = HTTPResponse(_FakeSock(c[0]))  # type: ignore[arg-type]
    r.begin()
    assert r.status == 200 and r.read() == b'{"ok":1}\n'
    with pytest.raises(TypeError):
        native._c_format_responses([(200, "not-bytes")])
    with pytest.raises(TypeError):
        native._c_format_responses([200])


/* walcodec: the WAL record codec hot path in C.
 *
 * The framework's durability layer (etcd_tpu_torch/wal/wal.py and
 * etcd_tpu_torch/server/enginewal.py) frames records as
 *     type:u32  crc:u32  len:u64  payload[len]          (little-endian)
 * with crc = rolling CRC32 (zlib polynomial) over every payload byte
 * written so far, seeded across segments by a CRC record — the reference's
 * Castagnoli-chain scheme (wal/wal.go:60).
 *
 * This module implements batch encode (many records -> one buffer + final
 * chain value, one Python call per fsync batch) and verified scan
 * (decode + CRC check of a whole segment in one pass, stopping cleanly at
 * a torn tail or bit flip). The Python implementations remain as the
 * portable fallback; tests assert byte-identical output (see
 * tests/test_native.py). Built by ./build via setuptools; loading is
 * optional everywhere.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* -- CRC32 (zlib polynomial, bit-reflected), table-driven ---------------- */

static uint32_t crc_table[256];

static void crc_init(void) {
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[n] = c;
    }
}

static uint32_t crc32_update(uint32_t crc, const uint8_t *buf, Py_ssize_t len) {
    crc ^= 0xFFFFFFFFu;
    for (Py_ssize_t i = 0; i < len; i++)
        crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

/* -- encode_records([(type, payload), ...], crc) -> (bytes, crc) --------- */

static PyObject *encode_records(PyObject *self, PyObject *args) {
    PyObject *records;
    unsigned int crc;
    if (!PyArg_ParseTuple(args, "OI", &records, &crc))
        return NULL;
    PyObject *seq = PySequence_Fast(records, "records must be a sequence");
    if (!seq) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

    /* total size first */
    Py_ssize_t total = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        PyObject *payload = PyTuple_GetItem(item, 1);
        if (!payload || !PyBytes_Check(payload)) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_TypeError,
                            "record payload must be bytes");
            return NULL;
        }
        total += 16 + PyBytes_GET_SIZE(payload);
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, total);
    if (!out) { Py_DECREF(seq); return NULL; }
    uint8_t *p = (uint8_t *)PyBytes_AS_STRING(out);

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        unsigned long rtype = PyLong_AsUnsignedLong(PyTuple_GetItem(item, 0));
        if (rtype == (unsigned long)-1 && PyErr_Occurred()) {
            Py_DECREF(seq); Py_DECREF(out); return NULL;
        }
        PyObject *payload = PyTuple_GetItem(item, 1);
        const uint8_t *data = (const uint8_t *)PyBytes_AS_STRING(payload);
        uint64_t len = (uint64_t)PyBytes_GET_SIZE(payload);

        crc = crc32_update(crc, data, (Py_ssize_t)len);
        uint32_t t32 = (uint32_t)rtype, c32 = crc;
        memcpy(p, &t32, 4);           /* little-endian hosts only (x86/arm) */
        memcpy(p + 4, &c32, 4);
        memcpy(p + 8, &len, 8);
        memcpy(p + 16, data, len);
        p += 16 + len;
    }
    Py_DECREF(seq);
    return Py_BuildValue("(NI)", out, crc);
}

/* -- scan_records(data, crc) -> (list[(type, payload)], crc, consumed) --- */

static PyObject *scan_records(PyObject *self, PyObject *args) {
    Py_buffer buf;
    unsigned int crc;
    if (!PyArg_ParseTuple(args, "y*I", &buf, &crc))
        return NULL;
    const uint8_t *p = (const uint8_t *)buf.buf;
    Py_ssize_t remaining = buf.len, consumed = 0;
    PyObject *out = PyList_New(0);
    if (!out) { PyBuffer_Release(&buf); return NULL; }

    while (remaining >= 16) {
        uint32_t rtype, rcrc;
        uint64_t len;
        memcpy(&rtype, p, 4);
        memcpy(&rcrc, p + 4, 4);
        memcpy(&len, p + 8, 8);
        if ((uint64_t)(remaining - 16) < len)
            break;                               /* torn tail */
        uint32_t c = crc32_update(crc, p + 16, (Py_ssize_t)len);
        if (c != rcrc)
            break;                               /* bit flip: stop clean */
        crc = c;
        PyObject *rec = Py_BuildValue(
            "(Iy#)", rtype, (const char *)(p + 16), (Py_ssize_t)len);
        if (!rec || PyList_Append(out, rec) < 0) {
            Py_XDECREF(rec); Py_DECREF(out); PyBuffer_Release(&buf);
            return NULL;
        }
        Py_DECREF(rec);
        p += 16 + len;
        consumed += 16 + (Py_ssize_t)len;
        remaining -= 16 + (Py_ssize_t)len;
    }
    PyBuffer_Release(&buf);
    return Py_BuildValue("(NIn)", out, crc, consumed);
}

/* One multi-request log-entry payload from its coalesced items — the
 * C twin of server/engine._pack_entry's multi branch (byte-identical;
 * tests/test_native.py pins it). Item = (rid, tagged_payload, ...);
 * each payload's leading tag byte is stripped and re-framed as
 * u32 length + body under one P_MULTI header. Per-item Python cost
 * (slice copy + struct.pack + two list appends) was ~1.3 us/request of
 * the serving engine's stage phase at deep queues — here it is one
 * length pass + one memcpy pass. */
static PyObject *pack_multi(PyObject *self, PyObject *args) {
    PyObject *items;
    int tag;
    if (!PyArg_ParseTuple(args, "O!i", &PyList_Type, &items, &tag))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(items);
    size_t total = 1 + 4;                /* tag byte + u32 count */
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = PyList_GET_ITEM(items, i);
        if (!PyTuple_Check(it) || PyTuple_GET_SIZE(it) < 2) {
            PyErr_SetString(PyExc_TypeError,
                            "item must be a (rid, payload, ...) tuple");
            return NULL;
        }
        PyObject *pl = PyTuple_GET_ITEM(it, 1);
        if (!PyBytes_Check(pl) || PyBytes_GET_SIZE(pl) < 1) {
            PyErr_SetString(PyExc_TypeError,
                            "payload must be non-empty bytes");
            return NULL;
        }
        if ((size_t)(PyBytes_GET_SIZE(pl) - 1) > (size_t)UINT32_MAX) {
            PyErr_SetString(PyExc_OverflowError,
                            "entry payload exceeds u32 framing");
            return NULL;
        }
        total += 4 + (size_t)(PyBytes_GET_SIZE(pl) - 1);
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)total);
    if (out == NULL)
        return NULL;
    unsigned char *w = (unsigned char *)PyBytes_AS_STRING(out);
    *w++ = (unsigned char)tag;
#define PUT_LE32(p, v)                                                  \
    do {                                                                \
        (p)[0] = (unsigned char)((v) & 0xff);                           \
        (p)[1] = (unsigned char)(((v) >> 8) & 0xff);                    \
        (p)[2] = (unsigned char)(((v) >> 16) & 0xff);                   \
        (p)[3] = (unsigned char)(((v) >> 24) & 0xff);                   \
    } while (0)
    PUT_LE32(w, (uint32_t)n);            /* struct.pack("<I") framing */
    w += 4;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *pl = PyTuple_GET_ITEM(PyList_GET_ITEM(items, i), 1);
        uint32_t ln = (uint32_t)(PyBytes_GET_SIZE(pl) - 1);
        PUT_LE32(w, ln);
        w += 4;
        memcpy(w, PyBytes_AS_STRING(pl) + 1, ln);
        w += ln;
    }
#undef PUT_LE32
    return out;
}

static PyMethodDef methods[] = {
    {"pack_multi", pack_multi, METH_VARARGS,
     "pack_multi(items:list[(rid, tagged_payload, ...)], tag:int)"
     " -> bytes (P_MULTI entry payload)"},
    {"encode_records", encode_records, METH_VARARGS,
     "encode_records(seq[(type:int, payload:bytes)], crc:int)"
     " -> (bytes, crc)"},
    {"scan_records", scan_records, METH_VARARGS,
     "scan_records(data:bytes, crc:int)"
     " -> (list[(type, payload)], crc, consumed)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "walcodec",
    "C hot path for WAL record framing + rolling CRC", -1, methods};

PyMODINIT_FUNC PyInit_walcodec(void) {
    crc_init();
    return PyModule_Create(&moduledef);
}

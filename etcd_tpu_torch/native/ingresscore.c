/* ingresscore: the ingress tier's per-request hot loop in C.
 *
 * The coalescing ingress (etcd_tpu_torch/server/ingress.py) holds 10k+
 * shallow client connections on one epoll loop; at that fan-in the
 * pure-Python per-request work — find("\r\n\r\n"), split/partition
 * header parsing, f-string response assembly — IS the serving cost
 * (docs/perf.md round 10 measured the engine idling behind it). This
 * module replaces both directions of that loop with one C pass each:
 *
 *   scan_requests(data) -> (reqs, consumed, err)
 *       Scan a connection's read buffer and emit every COMPLETE
 *       pipelined HTTP/1.1 request as a
 *       (method, target, content_type, authorization, close, body)
 *       tuple. Only the four headers the ingress dispatch actually
 *       reads are extracted (Content-Length to frame the body;
 *       Content-Type for form decoding; Authorization for per-slot
 *       identity; Connection for close). The byte scan runs with the
 *       GIL RELEASED (offsets recorded into a C array); Python objects
 *       materialize in a second pass under the GIL. `consumed` bytes
 *       must be dropped from the buffer; err != 0 poisons the
 *       connection (codes below match the Python fallback).
 *
 *   format_responses([(status, body), ...]) -> [bytes, ...]
 *       Materialize N complete HTTP/1.1 responses (JSON content-type,
 *       Content-Length framing) in one call — the ack fan-back path
 *       formats a whole upstream flush's responses without per-request
 *       Python string assembly.
 *
 * The Python implementations in server/ingress.py remain the reference
 * fallbacks; tests/test_native.py asserts identical outputs. Built by
 * ./build; loading is optional everywhere.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* Limits mirror server/ingress.py (_MAX_HEADER/_MAX_BODY). */
#define ING_MAX_HEADER (64 * 1024)
#define ING_MAX_BODY   (4 * 1024 * 1024)
#define ING_MAX_REQS   128          /* per call; leftovers rescan later */

/* Error codes (shared with the Python fallback). */
#define ING_OK               0
#define ING_EBADLINE         1      /* malformed request line */
#define ING_EBADLEN          2      /* malformed Content-Length */
#define ING_EBODY            3      /* body larger than ING_MAX_BODY */
#define ING_EHEADERS         4      /* header block larger than cap */

typedef struct {
    Py_ssize_t method_off, method_len;
    Py_ssize_t target_off, target_len;
    Py_ssize_t ctype_off, ctype_len;        /* -1 off = absent */
    Py_ssize_t auth_off, auth_len;
    Py_ssize_t body_off, body_len;
    int close;
} ing_req;

static int ieq(const uint8_t *s, Py_ssize_t n, const char *lit) {
    for (Py_ssize_t i = 0; i < n; i++) {
        uint8_t c = s[i];
        if (c >= 'A' && c <= 'Z') c += 32;
        if (c != (uint8_t)lit[i]) return 0;
    }
    return lit[n] == '\0';
}

static void trim(const uint8_t *p, Py_ssize_t *off, Py_ssize_t *len) {
    while (*len > 0 && (p[*off] == ' ' || p[*off] == '\t')) {
        (*off)++; (*len)--;
    }
    while (*len > 0 && (p[*off + *len - 1] == ' '
                        || p[*off + *len - 1] == '\t'))
        (*len)--;
}

/* Pure-C scan pass: fills reqs[], returns request count; *consumed and
 * *err as in the Python API. Runs without the GIL. */
static int scan_pass(const uint8_t *p, Py_ssize_t n, ing_req *reqs,
                     Py_ssize_t *consumed, int *err) {
    int count = 0;
    Py_ssize_t off = 0;
    *err = ING_OK;
    while (count < ING_MAX_REQS) {
        /* locate end of header block */
        Py_ssize_t end = -1;
        for (Py_ssize_t i = off; i + 3 < n; i++) {
            if (p[i] == '\r' && p[i + 1] == '\n' && p[i + 2] == '\r'
                && p[i + 3] == '\n') { end = i; break; }
            if (i - off > ING_MAX_HEADER) break;
        }
        if (end < 0) {
            if (n - off > ING_MAX_HEADER) *err = ING_EHEADERS;
            break;
        }
        ing_req *r = &reqs[count];
        memset(r, 0, sizeof(*r));
        r->ctype_off = r->auth_off = -1;
        /* request line: METHOD SP TARGET SP VERSION */
        Py_ssize_t i = off;
        Py_ssize_t eol = i;
        while (eol < end && p[eol] != '\r') eol++;
        Py_ssize_t sp1 = i;
        while (sp1 < eol && p[sp1] != ' ') sp1++;
        Py_ssize_t sp2 = sp1 + 1;
        while (sp2 < eol && p[sp2] != ' ') sp2++;
        if (sp1 >= eol || sp2 >= eol) { *err = ING_EBADLINE; break; }
        r->method_off = i;            r->method_len = sp1 - i;
        r->target_off = sp1 + 1;      r->target_len = sp2 - sp1 - 1;
        /* headers of interest */
        int64_t clen = 0;
        Py_ssize_t ln = eol + 2;
        while (ln < end + 2) {
            Py_ssize_t le = ln;
            while (le < end && p[le] != '\r') le++;
            Py_ssize_t colon = ln;
            while (colon < le && p[colon] != ':') colon++;
            if (colon < le) {
                Py_ssize_t koff = ln, klen = colon - ln;
                trim(p, &koff, &klen);
                Py_ssize_t voff = colon + 1, vlen = le - colon - 1;
                trim(p, &voff, &vlen);
                if (ieq(p + koff, klen, "content-length")) {
                    if (vlen > 18) { *err = ING_EBADLEN; break; }
                    clen = 0;      /* empty value reads as 0 (fallback) */
                    for (Py_ssize_t k = 0; k < vlen; k++) {
                        uint8_t c = p[voff + k];
                        if (c < '0' || c > '9') {
                            *err = ING_EBADLEN; break;
                        }
                        clen = clen * 10 + (c - '0');
                    }
                    if (*err) break;
                } else if (ieq(p + koff, klen, "content-type")) {
                    r->ctype_off = voff; r->ctype_len = vlen;
                } else if (ieq(p + koff, klen, "authorization")) {
                    r->auth_off = voff; r->auth_len = vlen;
                } else if (ieq(p + koff, klen, "connection")) {
                    if (ieq(p + voff, vlen, "close")) r->close = 1;
                }
            }
            ln = le + 2;
        }
        if (*err) break;
        if (clen > ING_MAX_BODY) { *err = ING_EBODY; break; }
        if (end + 4 + clen > n) break;          /* incomplete body */
        r->body_off = end + 4;
        r->body_len = (Py_ssize_t)clen;
        off = end + 4 + (Py_ssize_t)clen;
        *consumed = off;
        count++;
    }
    return count;
}

/* scan_requests(data) ->
 *     ([(method, target, ctype|None, auth|None, close, body)], consumed,
 *      err) */
static PyObject *scan_requests(PyObject *self, PyObject *args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf))
        return NULL;
    const uint8_t *p = (const uint8_t *)buf.buf;
    Py_ssize_t n = buf.len, consumed = 0;
    int err = ING_OK, count = 0;
    ing_req reqs[ING_MAX_REQS];

    Py_BEGIN_ALLOW_THREADS
    count = scan_pass(p, n, reqs, &consumed, &err);
    Py_END_ALLOW_THREADS

    PyObject *out = PyList_New(count);
    if (!out) { PyBuffer_Release(&buf); return NULL; }
    for (int i = 0; i < count; i++) {
        ing_req *r = &reqs[i];
        PyObject *ctype = Py_None, *auth = Py_None;
        if (r->ctype_off >= 0) {
            ctype = PyUnicode_DecodeLatin1(
                (const char *)p + r->ctype_off, r->ctype_len, NULL);
        } else Py_INCREF(Py_None);
        if (!ctype) { Py_DECREF(out); PyBuffer_Release(&buf); return NULL; }
        if (r->auth_off >= 0) {
            auth = PyUnicode_DecodeLatin1(
                (const char *)p + r->auth_off, r->auth_len, NULL);
        } else Py_INCREF(Py_None);
        if (!auth) {
            Py_DECREF(ctype); Py_DECREF(out); PyBuffer_Release(&buf);
            return NULL;
        }
        PyObject *tup = Py_BuildValue(
            "(NNNNOy#)",
            PyUnicode_DecodeLatin1((const char *)p + r->method_off,
                                   r->method_len, NULL),
            PyUnicode_DecodeLatin1((const char *)p + r->target_off,
                                   r->target_len, NULL),
            ctype, auth, r->close ? Py_True : Py_False,
            (const char *)p + r->body_off, r->body_len);
        if (!tup) { Py_DECREF(out); PyBuffer_Release(&buf); return NULL; }
        PyList_SET_ITEM(out, i, tup);
    }
    PyBuffer_Release(&buf);
    return Py_BuildValue("(Nni)", out, consumed, err);
}

/* -- format_responses ---------------------------------------------------- */

static const char *reason_of(long status) {
    switch (status) {
    case 200: return "OK";
    case 201: return "Created";
    case 400: return "Bad Request";
    case 401: return "Unauthorized";
    case 403: return "Forbidden";
    case 404: return "Not Found";
    case 405: return "Method Not Allowed";
    case 408: return "Request Timeout";
    case 412: return "Precondition Failed";
    case 500: return "Internal Server Error";
    case 503: return "Service Unavailable";
    default:  return "OK";
    }
}

/* format_responses([(status:int, body:bytes), ...]) -> [bytes, ...] */
static PyObject *format_responses(PyObject *self, PyObject *args) {
    PyObject *items;
    if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &items))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(items);
    PyObject *out = PyList_New(n);
    if (!out) return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = PyList_GET_ITEM(items, i);
        if (!PyTuple_Check(it) || PyTuple_GET_SIZE(it) != 2) {
            Py_DECREF(out);
            PyErr_SetString(PyExc_TypeError,
                            "item must be a (status, body) tuple");
            return NULL;
        }
        long status = PyLong_AsLong(PyTuple_GET_ITEM(it, 0));
        if (status == -1 && PyErr_Occurred()) { Py_DECREF(out); return NULL; }
        PyObject *body = PyTuple_GET_ITEM(it, 1);
        if (!PyBytes_Check(body)) {
            Py_DECREF(out);
            PyErr_SetString(PyExc_TypeError, "body must be bytes");
            return NULL;
        }
        Py_ssize_t blen = PyBytes_GET_SIZE(body);
        char head[160];
        int hlen = snprintf(
            head, sizeof(head),
            "HTTP/1.1 %ld %s\r\n"
            "Content-Type: application/json\r\n"
            "Content-Length: %zd\r\n\r\n",
            status, reason_of(status), blen);
        if (hlen < 0 || (size_t)hlen >= sizeof(head)) {
            Py_DECREF(out);
            PyErr_SetString(PyExc_ValueError, "response head overflow");
            return NULL;
        }
        PyObject *resp = PyBytes_FromStringAndSize(NULL, hlen + blen);
        if (!resp) { Py_DECREF(out); return NULL; }
        char *w = PyBytes_AS_STRING(resp);
        memcpy(w, head, (size_t)hlen);
        memcpy(w + hlen, PyBytes_AS_STRING(body), (size_t)blen);
        PyList_SET_ITEM(out, i, resp);
    }
    return out;
}

static PyMethodDef methods[] = {
    {"scan_requests", scan_requests, METH_VARARGS,
     "scan_requests(data:bytes) -> (list[(method, target, ctype, auth, "
     "close, body)], consumed:int, err:int)"},
    {"format_responses", format_responses, METH_VARARGS,
     "format_responses(list[(status:int, body:bytes)]) -> list[bytes]"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "ingresscore",
    "C hot path for ingress HTTP request scan + response formatting",
    -1, methods};

PyMODINIT_FUNC PyInit_ingresscore(void) {
    return PyModule_Create(&moduledef);
}

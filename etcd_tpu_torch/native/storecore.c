/* storecore: native core of the v2 store's node tree.
 *
 * Owns the hierarchical key tree, the TTL min-heap and the op stats
 * counters of one tenant keyspace — the per-request hot path of the
 * multi-tenant engine's apply loop (reference store/store.go:66-677,
 * store/node.go, store/ttl_key_heap.go, store/stats.go). Everything
 * event-shaped stays in Python: the facade (store/native_store.py)
 * builds Event/NodeExtern objects from the compact descriptors returned
 * here and drives the unchanged WatcherHub. Semantics are pinned by
 * running the full Python-store test matrix against the facade plus a
 * randomized differential test (tests/test_native_store.py).
 *
 * Concurrency: every op is ONE C call executed under the GIL with no
 * intervening Python callbacks, so ops are atomic with respect to other
 * Python threads — the facade needs no per-op lock (the Python store's
 * RLock guarded multi-step Python sequences that don't exist here).
 *
 * Node descriptors crossing the boundary:
 *   desc      = (key, value|None, is_dir, created, modified, expire|None)
 *   get-tree  = desc + (children-tuple | None,)   [7-tuple, recursive]
 * Errors raise etcd_tpu_torch.errors.EtcdError(code, cause, index) directly.
 */
#define _GNU_SOURCE /* memrchr */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pythread.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

/* ---------------------------------------------------------------- errors */

static PyObject *EtcdError;  /* etcd_tpu_torch.errors.EtcdError */

#define ECODE_KEY_NOT_FOUND 100
#define ECODE_TEST_FAILED 101
#define ECODE_NOT_FILE 102
#define ECODE_NOT_DIR 104
#define ECODE_NODE_EXIST 105
#define ECODE_ROOT_RONLY 107
#define ECODE_DIR_NOT_EMPTY 108

static void
raise_etcd(int code, const char *cause, Py_ssize_t cause_len, uint64_t index)
{
    PyObject *exc = NULL, *c = NULL;
    c = PyUnicode_FromStringAndSize(cause, cause_len);
    if (c == NULL)
        return;
    exc = PyObject_CallFunction(EtcdError, "iOK", code, c,
                                (unsigned long long)index);
    Py_DECREF(c);
    if (exc == NULL)
        return;
    PyErr_SetObject(EtcdError, exc);
    Py_DECREF(exc);
}

/* ------------------------------------------------------------------ node */

typedef struct CMap CMap;

typedef struct CNode {
    char *path;            /* full normalized path, owned */
    uint32_t path_len;
    char *value;           /* owned; NULL for dirs ("" for empty files) */
    Py_ssize_t value_len;
    uint64_t created, modified;
    double expire;         /* NAN = permanent */
    CMap *children;        /* NULL for files */
    struct CNode *parent;  /* borrowed (tree structure) */
    uint32_t name_off;     /* name = path + name_off (last component) */
    int refcnt;            /* tree ref + TTL-heap refs */
    uint8_t dead;          /* detached from the tree */
    uint8_t hidden;        /* name starts with '_' */
} CNode;

/* Ordered hash map: open addressing over an insertion-order array, so
 * listings and JSON dumps reproduce the Python dict's insertion order
 * byte-for-byte. Slot values: 0 empty, 1 tombstone, pos+2 otherwise. */
struct CMap {
    uint32_t nslots;       /* power of two */
    uint32_t nused;        /* live entries */
    uint32_t norder;       /* entries in order[] including holes */
    uint32_t *slots;
    CNode **order;         /* NULL holes after deletes */
};

static uint32_t
fnv1a(const char *s, uint32_t len)
{
    uint32_t h = 2166136261u;
    for (uint32_t i = 0; i < len; i++) {
        h ^= (uint8_t)s[i];
        h *= 16777619u;
    }
    return h;
}

static const char *
node_name(const CNode *n, uint32_t *len)
{
    *len = n->path_len - n->name_off;
    return n->path + n->name_off;
}

static CMap *
cmap_new(void)
{
    CMap *m = (CMap *)calloc(1, sizeof(CMap));
    if (m == NULL)
        return NULL;
    m->nslots = 8;
    m->slots = (uint32_t *)calloc(m->nslots, sizeof(uint32_t));
    m->order = NULL;
    if (m->slots == NULL) {
        free(m);
        return NULL;
    }
    return m;
}

static void node_decref(CNode *n);

static void
cmap_free(CMap *m)
{
    if (m == NULL)
        return;
    for (uint32_t i = 0; i < m->norder; i++)
        if (m->order[i] != NULL)
            node_decref(m->order[i]);
    free(m->slots);
    free(m->order);
    free(m);
}

static CNode *
cmap_get(const CMap *m, const char *name, uint32_t len)
{
    uint32_t mask = m->nslots - 1;
    uint32_t i = fnv1a(name, len) & mask;
    for (;;) {
        uint32_t v = m->slots[i];
        if (v == 0)
            return NULL;
        if (v >= 2) {
            CNode *n = m->order[v - 2];
            uint32_t nl;
            const char *nn = node_name(n, &nl);
            if (nl == len && memcmp(nn, name, len) == 0)
                return n;
        }
        i = (i + 1) & mask;
    }
}

static int cmap_insert_slot(CMap *m, CNode *n, uint32_t pos);

static int
cmap_grow(CMap *m)
{
    uint32_t new_slots = m->nslots * 2;
    uint32_t *old = m->slots;
    m->slots = (uint32_t *)calloc(new_slots, sizeof(uint32_t));
    if (m->slots == NULL) {
        m->slots = old;
        return -1;
    }
    m->nslots = new_slots;
    /* compact the order array while rehashing */
    uint32_t w = 0;
    for (uint32_t i = 0; i < m->norder; i++) {
        CNode *n = m->order[i];
        if (n == NULL)
            continue;
        m->order[w] = n;
        cmap_insert_slot(m, n, w);
        w++;
    }
    m->norder = w;
    free(old);
    return 0;
}

static int
cmap_insert_slot(CMap *m, CNode *n, uint32_t pos)
{
    uint32_t nl;
    const char *nn = node_name(n, &nl);
    uint32_t mask = m->nslots - 1;
    uint32_t i = fnv1a(nn, nl) & mask;
    while (m->slots[i] >= 2)
        i = (i + 1) & mask;
    m->slots[i] = pos + 2;
    return 0;
}

/* Takes over one reference to n. */
static int
cmap_add(CMap *m, CNode *n)
{
    if ((m->nused + 1) * 3 >= m->nslots * 2)
        if (cmap_grow(m) < 0)
            return -1;
    if (m->norder % 8 == 0) {
        CNode **no = (CNode **)realloc(m->order,
                                       (m->norder + 8) * sizeof(CNode *));
        if (no == NULL)
            return -1;
        m->order = no;
    }
    m->order[m->norder] = n;
    cmap_insert_slot(m, n, m->norder);
    m->norder++;
    m->nused++;
    return 0;
}

/* Drops the map's reference to the removed node. */
static void
cmap_del(CMap *m, const char *name, uint32_t len)
{
    uint32_t mask = m->nslots - 1;
    uint32_t i = fnv1a(name, len) & mask;
    for (;;) {
        uint32_t v = m->slots[i];
        if (v == 0)
            return;
        if (v >= 2) {
            CNode *n = m->order[v - 2];
            uint32_t nl;
            const char *nn = node_name(n, &nl);
            if (nl == len && memcmp(nn, name, len) == 0) {
                m->order[v - 2] = NULL;
                m->slots[i] = 1; /* tombstone */
                m->nused--;
                node_decref(n);
                return;
            }
        }
        i = (i + 1) & mask;
    }
}

static CNode *
node_new(const char *path, uint32_t path_len, uint64_t created,
         uint64_t modified, CNode *parent, const char *value,
         Py_ssize_t value_len, int is_dir, double expire)
{
    CNode *n = (CNode *)calloc(1, sizeof(CNode));
    if (n == NULL)
        return NULL;
    n->path = (char *)malloc(path_len + 1);
    if (n->path == NULL) {
        free(n);
        return NULL;
    }
    memcpy(n->path, path, path_len);
    n->path[path_len] = 0;
    n->path_len = path_len;
    const char *slash = memrchr(path, '/', path_len);
    n->name_off = slash ? (uint32_t)(slash - path) + 1 : 0;
    n->hidden = (n->name_off < path_len && path[n->name_off] == '_');
    n->created = created;
    n->modified = modified;
    n->parent = parent;
    n->expire = expire;
    n->refcnt = 1;
    if (is_dir) {
        n->children = cmap_new();
        if (n->children == NULL) {
            free(n->path);
            free(n);
            return NULL;
        }
    } else {
        if (value == NULL) {
            value = "";
            value_len = 0;
        }
        n->value = (char *)malloc(value_len + 1);
        if (n->value == NULL) {
            free(n->path);
            free(n);
            return NULL;
        }
        memcpy(n->value, value, value_len);
        n->value[value_len] = 0;
        n->value_len = value_len;
    }
    return n;
}

static void
node_decref(CNode *n)
{
    if (--n->refcnt > 0)
        return;
    cmap_free(n->children);
    free(n->path);
    free(n->value);
    free(n);
}

static int
node_set_value(CNode *n, const char *value, Py_ssize_t len)
{
    char *v = (char *)malloc(len + 1);
    if (v == NULL)
        return -1;
    memcpy(v, value, len);
    v[len] = 0;
    free(n->value);
    n->value = v;
    n->value_len = len;
    return 0;
}

/* -------------------------------------------------------------- TTL heap */

typedef struct {
    double expire;
    CNode *node; /* holds one reference */
} HeapEnt;

/* Orders by (expire, path) to match the Python heapq of (time, path)
 * tuples — equal-deadline nodes expire in path order on every replica. */
static int
heap_lt(const HeapEnt *a, const HeapEnt *b)
{
    if (a->expire != b->expire)
        return a->expire < b->expire;
    uint32_t la = a->node->path_len, lb = b->node->path_len;
    int r = memcmp(a->node->path, b->node->path, la < lb ? la : lb);
    if (r != 0)
        return r < 0;
    return la < lb;
}

/* ------------------------------------------------------------------ core */

#define NSTATS 16
/* Indices mirror store.Stats.FIELDS order. */
enum {
    ST_GETS_OK, ST_GETS_FAIL, ST_SETS_OK, ST_SETS_FAIL,
    ST_CREATE_OK, ST_CREATE_FAIL, ST_UPDATE_OK, ST_UPDATE_FAIL,
    ST_DELETE_OK, ST_DELETE_FAIL, ST_CAS_OK, ST_CAS_FAIL,
    ST_CAD_OK, ST_CAD_FAIL, ST_EXPIRE, ST_WATCHERS,
};

/* Event-history ring record (reference store/event_history.go): the
 * result descriptors every mutation already builds, retained verbatim so
 * `watch ?waitIndex=` scans replay them — the facade materializes an
 * Event object only when a scan or a live watcher actually needs one. */
typedef struct {
    int action;          /* index into the facade's ACTIONS table */
    PyObject *nd, *pd;   /* desc tuples; pd may be Py_None */
    uint64_t index;      /* == node.modified == X-Etcd-Index of the op */
    double now;          /* clock at event time (TTL materialization) */
} RingRec;

enum {
    ACT_SET, ACT_CREATE, ACT_UPDATE, ACT_CAS, ACT_DELETE, ACT_CAD,
    ACT_EXPIRE,
};

typedef struct {
    PyObject_HEAD
    CNode *root;
    uint64_t current_index;
    HeapEnt *heap;
    Py_ssize_t heap_len, heap_cap;
    long long stats[NSTATS];
    PyObject *namespaces; /* tuple of str: write-protected top-level dirs */
    /* C copies of `namespaces` so the readonly check runs without the
     * GIL (set_many's batch phase). Immutable after construction. */
    char **ns_c;
    Py_ssize_t *ns_len;
    Py_ssize_t ns_n;
    RingRec *ring;        /* circular event history */
    Py_ssize_t ring_cap, ring_len, ring_head; /* head = oldest */
    /* Serializes tree/heap/ring/stats access against set_many's
     * GIL-RELEASED batch phase: every Python-visible entry point takes
     * it (core_lock), so a reader on an HTTP thread never walks a tree
     * mid-mutation. Before the batch phase existed the GIL alone made
     * every entry atomic; the mutex restores that guarantee per Core
     * while letting K applier shards mutate DISJOINT cores in
     * parallel. */
    PyThread_type_lock mux;
} CoreObject;

static void
core_lock(CoreObject *c)
{
    /* Uncontended fast path: one atomic try, no GIL churn. On
     * contention, RELEASE THE GIL before blocking: the holder may be
     * set_many's batch phase, whose descriptor-building tail must
     * reacquire the GIL while still holding the mutex — a thread
     * waiting on the mutex WITH the GIL would deadlock it. Invariant:
     * no thread ever blocks on the mutex while holding the GIL. */
    if (PyThread_acquire_lock(c->mux, NOWAIT_LOCK))
        return;
    Py_BEGIN_ALLOW_THREADS
    PyThread_acquire_lock(c->mux, WAIT_LOCK);
    Py_END_ALLOW_THREADS
}

#define core_unlock(c) PyThread_release_lock((c)->mux)

/* Locked trampoline: METH_NOARGS handlers share the same C signature
 * (second arg NULL), so one shape covers the whole method table. While
 * the mutex is held the body may still run Python code (tuple builds,
 * EtcdError construction) and the GIL may switch threads — any thread
 * that then enters THIS core parks on the mutex with the GIL released
 * (core_lock), so progress is never lost. */
#define LOCKED(name) \
static PyObject * \
name##_L(CoreObject *c, PyObject *args) \
{ \
    core_lock(c); \
    PyObject *r = name(c, args); \
    core_unlock(c); \
    return r; \
}

static int
ring_push(CoreObject *c, int action, PyObject *nd, PyObject *pd,
          uint64_t index, double now)
{
    if (c->ring_cap == 0)
        return 0;
    RingRec *r;
    if (c->ring_len == c->ring_cap) {
        r = &c->ring[c->ring_head];
        Py_DECREF(r->nd);
        Py_DECREF(r->pd);
        c->ring_head = (c->ring_head + 1) % c->ring_cap;
    } else {
        r = &c->ring[(c->ring_head + c->ring_len) % c->ring_cap];
        c->ring_len++;
    }
    if (pd == NULL)
        pd = Py_None;
    Py_INCREF(nd);
    Py_INCREF(pd);
    r->action = action;
    r->nd = nd;
    r->pd = pd;
    r->index = index;
    r->now = now;
    return 0;
}

static int
heap_push(CoreObject *c, CNode *n)
{
    if (isnan(n->expire))
        return 0;
    if (c->heap_len == c->heap_cap) {
        Py_ssize_t nc = c->heap_cap ? c->heap_cap * 2 : 16;
        HeapEnt *nh = (HeapEnt *)realloc(c->heap, nc * sizeof(HeapEnt));
        if (nh == NULL)
            return -1;
        c->heap = nh;
        c->heap_cap = nc;
    }
    Py_ssize_t i = c->heap_len++;
    c->heap[i].expire = n->expire;
    c->heap[i].node = n;
    n->refcnt++;
    while (i > 0) {
        Py_ssize_t p = (i - 1) / 2;
        if (!heap_lt(&c->heap[i], &c->heap[p]))
            break;
        HeapEnt t = c->heap[i];
        c->heap[i] = c->heap[p];
        c->heap[p] = t;
        i = p;
    }
    return 0;
}

static void
heap_pop(CoreObject *c)
{
    if (c->heap_len == 0)
        return;
    node_decref(c->heap[0].node);
    c->heap[0] = c->heap[--c->heap_len];
    Py_ssize_t i = 0;
    for (;;) {
        Py_ssize_t l = 2 * i + 1, r = l + 1, s = i;
        if (l < c->heap_len && heap_lt(&c->heap[l], &c->heap[s]))
            s = l;
        if (r < c->heap_len && heap_lt(&c->heap[r], &c->heap[s]))
            s = r;
        if (s == i)
            break;
        HeapEnt t = c->heap[i];
        c->heap[i] = c->heap[s];
        c->heap[s] = t;
        i = s;
    }
}

/* Pop stale entries (dead node or superseded deadline — the Python heap's
 * lazy invalidation, ttl_key_heap.go semantics); return live top or NULL. */
static CNode *
heap_top(CoreObject *c)
{
    while (c->heap_len > 0) {
        HeapEnt *e = &c->heap[0];
        if (e->node->dead || e->node->expire != e->expire) {
            heap_pop(c);
            continue;
        }
        return e->node;
    }
    return NULL;
}

/* --------------------------------------------------------- descriptors */

static PyObject *
node_desc(const CNode *n)
{
    PyObject *t = PyTuple_New(6);
    if (t == NULL)
        return NULL;
    PyObject *key = PyUnicode_FromStringAndSize(n->path, n->path_len);
    PyObject *val;
    if (n->children != NULL) {
        val = Py_None;
        Py_INCREF(val);
    } else {
        val = PyUnicode_FromStringAndSize(n->value, n->value_len);
    }
    PyObject *isdir = PyBool_FromLong(n->children != NULL);
    PyObject *cr = PyLong_FromUnsignedLongLong(n->created);
    PyObject *mo = PyLong_FromUnsignedLongLong(n->modified);
    PyObject *ex;
    if (isnan(n->expire)) {
        ex = Py_None;
        Py_INCREF(ex);
    } else {
        ex = PyFloat_FromDouble(n->expire);
    }
    if (!key || !val || !isdir || !cr || !mo || !ex) {
        Py_XDECREF(key); Py_XDECREF(val); Py_XDECREF(isdir);
        Py_XDECREF(cr); Py_XDECREF(mo); Py_XDECREF(ex);
        Py_DECREF(t);
        return NULL;
    }
    PyTuple_SET_ITEM(t, 0, key);
    PyTuple_SET_ITEM(t, 1, val);
    PyTuple_SET_ITEM(t, 2, isdir);
    PyTuple_SET_ITEM(t, 3, cr);
    PyTuple_SET_ITEM(t, 4, mo);
    PyTuple_SET_ITEM(t, 5, ex);
    return t;
}

/* ------------------------------------------------------------- tree walk */

/* Resolve an existing node; on failure raise KEY_NOT_FOUND with the full
 * requested path as cause (reference internalGet; walking INTO a file is
 * also KEY_NOT_FOUND, store.py _walk). */
static CNode *
core_walk(CoreObject *c, const char *path, Py_ssize_t len)
{
    CNode *cur = c->root;
    Py_ssize_t i = 0;
    while (i < len) {
        while (i < len && path[i] == '/')
            i++;
        if (i >= len)
            break;
        Py_ssize_t j = i;
        while (j < len && path[j] != '/')
            j++;
        if (cur->children == NULL)
            goto notfound;
        CNode *nxt = cmap_get(cur->children, path + i, (uint32_t)(j - i));
        if (nxt == NULL)
            goto notfound;
        cur = nxt;
        i = j;
    }
    return cur;
notfound:
    raise_etcd(ECODE_KEY_NOT_FOUND, path, len, c->current_index);
    return NULL;
}

/* Walk to dirname creating missing dirs at `index`. GIL-FREE variant
 * (set_many's batch phase): on failure returns NULL with *ecode set to
 * ECODE_NOT_DIR (cause = the blocking file's path, stable for the
 * batch: set_many never detaches nodes) or -1 for OOM. */
static CNode *
core_make_dirs_c(CoreObject *c, const char *path, Py_ssize_t len,
                 uint64_t index, int *ecode, const char **cause,
                 Py_ssize_t *clen)
{
    CNode *cur = c->root;
    Py_ssize_t i = 0;
    while (i < len) {
        while (i < len && path[i] == '/')
            i++;
        if (i >= len)
            break;
        Py_ssize_t j = i;
        while (j < len && path[j] != '/')
            j++;
        CNode *nxt = cmap_get(cur->children, path + i, (uint32_t)(j - i));
        if (nxt == NULL) {
            nxt = node_new(path, (uint32_t)j, index, index, cur, NULL, 0,
                           1, NAN);
            if (nxt == NULL || cmap_add(cur->children, nxt) < 0) {
                if (nxt)
                    node_decref(nxt);
                *ecode = -1;
                return NULL;
            }
        } else if (nxt->children == NULL) {
            *ecode = ECODE_NOT_DIR;
            *cause = nxt->path;
            *clen = nxt->path_len;
            return NULL;
        }
        cur = nxt;
        i = j;
    }
    return cur;
}

/* GIL-holding wrapper (reference walk with checkDir; store.py
 * _make_dirs): an existing FILE on the path raises 104 NOT_DIR with the
 * file's path as cause. */
static CNode *
core_make_dirs(CoreObject *c, const char *path, Py_ssize_t len,
               uint64_t index)
{
    int ecode = 0;
    const char *cause = NULL;
    Py_ssize_t clen = 0;
    CNode *n = core_make_dirs_c(c, path, len, index, &ecode, &cause,
                                &clen);
    if (n == NULL) {
        if (ecode == -1)
            PyErr_NoMemory();
        else
            raise_etcd(ecode, cause, clen, c->current_index);
    }
    return n;
}

/* GIL-free (reads only the C namespace copies built at construction). */
static int
core_is_readonly(const CoreObject *c, const char *path, Py_ssize_t len)
{
    if (len == 1 && path[0] == '/')
        return 1;
    for (Py_ssize_t i = 0; i < c->ns_n; i++)
        if (c->ns_len[i] == len && memcmp(c->ns_c[i], path, len) == 0)
            return 1;
    return 0;
}

/* Detach `n` from its parent; mark dead. Appends removed paths (children
 * first, then the node — reference node.go Remove order) to `removed`
 * when non-NULL. Caller has validated dir/recursive flags. */
static int
node_remove_rec(CNode *n, PyObject *removed)
{
    if (n->children != NULL) {
        /* snapshot: detaching mutates the map */
        uint32_t cnt = 0;
        for (uint32_t i = 0; i < n->children->norder; i++)
            if (n->children->order[i] != NULL)
                cnt++;
        if (cnt > 0) {
            CNode **kids = (CNode **)malloc(cnt * sizeof(CNode *));
            if (kids == NULL) {
                PyErr_NoMemory();
                return -1;
            }
            uint32_t w = 0;
            for (uint32_t i = 0; i < n->children->norder; i++)
                if (n->children->order[i] != NULL)
                    kids[w++] = n->children->order[i];
            for (uint32_t i = 0; i < w; i++) {
                if (node_remove_rec(kids[i], removed) < 0) {
                    free(kids);
                    return -1;
                }
            }
            free(kids);
        }
    }
    if (removed != NULL) {
        PyObject *p = PyUnicode_FromStringAndSize(n->path, n->path_len);
        if (p == NULL || PyList_Append(removed, p) < 0) {
            Py_XDECREF(p);
            return -1;
        }
        Py_DECREF(p);
    }
    n->dead = 1;
    if (n->parent != NULL && n->parent->children != NULL) {
        uint32_t nl;
        const char *nn = node_name(n, &nl);
        cmap_del(n->parent->children, nn, nl); /* drops the tree ref */
    }
    n->parent = NULL;
    return 0;
}

/* ----------------------------------------------------------- op helpers */

static void
split_dirname(const char *path, Py_ssize_t len, Py_ssize_t *dir_len,
              const char **name, Py_ssize_t *name_len)
{
    /* paths are normalized ("/x/y"): a '/' is always present */
    const char *slash = memrchr(path, '/', len);
    if (slash == NULL)
        slash = path;
    *dir_len = slash - path;
    *name = slash + 1;
    *name_len = len - (*dir_len + 1);
}

/* value arg: str or None. */
static int
parse_value(PyObject *o, const char **v, Py_ssize_t *vl)
{
    if (o == Py_None) {
        *v = NULL;
        *vl = 0;
        return 0;
    }
    *v = PyUnicode_AsUTF8AndSize(o, vl);
    return *v == NULL ? -1 : 0;
}

/* expire arg: float or None -> NAN. */
static int
parse_expire(PyObject *o, double *out)
{
    if (o == Py_None) {
        *out = NAN;
        return 0;
    }
    *out = PyFloat_AsDouble(o);
    return (*out == -1.0 && PyErr_Occurred()) ? -1 : 0;
}

static PyObject *
result3(PyObject *nd, PyObject *pd, uint64_t index)
{
    /* steals nd/pd; pd may be NULL meaning None */
    if (pd == NULL) {
        pd = Py_None;
        Py_INCREF(pd);
    }
    PyObject *idx = PyLong_FromUnsignedLongLong(index);
    if (nd == NULL || idx == NULL) {
        Py_XDECREF(nd); Py_XDECREF(pd); Py_XDECREF(idx);
        return NULL;
    }
    PyObject *t = PyTuple_New(3);
    if (t == NULL) {
        Py_DECREF(nd); Py_DECREF(pd); Py_DECREF(idx);
        return NULL;
    }
    PyTuple_SET_ITEM(t, 0, nd);
    PyTuple_SET_ITEM(t, 1, pd);
    PyTuple_SET_ITEM(t, 2, idx);
    return t;
}

/* --------------------------------------------------------------- set op */

/* The SET mutation body shared by Core_set and Core_set_many: applies one
 * set, records history, and hands back new-owned nd/pd descriptors.
 * Returns the new index, or 0 with the Python error set (etcd errors AND
 * fatal ones — callers distinguish via PyErr_GivenExceptionMatches). */
static uint64_t
set_apply(CoreObject *c, const char *path, Py_ssize_t plen,
          const char *value, Py_ssize_t vlen, int is_dir, double expire,
          double now, PyObject **nd_out, PyObject **pd_out)
{
    *nd_out = *pd_out = NULL;
    if (core_is_readonly(c, path, plen)) {
        c->stats[ST_SETS_FAIL]++;
        raise_etcd(ECODE_ROOT_RONLY, "/", 1, c->current_index);
        return 0;
    }
    uint64_t next = c->current_index + 1;
    Py_ssize_t dlen, nlen;
    const char *name;
    split_dirname(path, plen, &dlen, &name, &nlen);
    CNode *parent = core_make_dirs(c, path, dlen, next);
    if (parent == NULL) {
        c->stats[ST_SETS_FAIL]++;
        return 0;
    }
    CNode *existing = cmap_get(parent->children, name, (uint32_t)nlen);
    PyObject *prev = NULL;
    if (existing != NULL) {
        if (existing->children != NULL) {
            /* set over a dir: 102 (with OR without dir=True) */
            c->stats[ST_SETS_FAIL]++;
            raise_etcd(ECODE_NOT_FILE, path, plen, c->current_index);
            return 0;
        }
        prev = node_desc(existing);
        if (prev == NULL)
            return 0;
    }
    CNode *n;
    if (existing != NULL && !is_dir) {
        /* in-place replace: a SET is a brand-new node, both indices move */
        if (node_set_value(existing, value ? value : "", value ? vlen : 0)
                < 0) {
            Py_DECREF(prev);
            PyErr_NoMemory();
            return 0;
        }
        existing->created = existing->modified = next;
        existing->expire = expire;
        n = existing;
    } else {
        if (existing != NULL) {
            if (node_remove_rec(existing, NULL) < 0) {
                Py_XDECREF(prev);
                return 0;
            }
        }
        n = node_new(path, (uint32_t)plen, next, next, parent, value, vlen,
                     is_dir, expire);
        if (n == NULL || cmap_add(parent->children, n) < 0) {
            if (n)
                node_decref(n);
            Py_XDECREF(prev);
            PyErr_NoMemory();
            return 0;
        }
    }
    if (heap_push(c, n) < 0) {
        Py_XDECREF(prev);
        PyErr_NoMemory();
        return 0;
    }
    c->current_index = next;
    c->stats[ST_SETS_OK]++;
    PyObject *nd = node_desc(n);
    if (nd == NULL) {
        Py_XDECREF(prev);
        return 0;
    }
    ring_push(c, ACT_SET, nd, prev, next, now);
    *nd_out = nd;
    *pd_out = prev;   /* may be NULL (no previous node) */
    return next;
}

static PyObject *
Core_set(CoreObject *c, PyObject *args)
{
    const char *path, *value;
    Py_ssize_t plen, vlen;
    int is_dir;
    double now;
    PyObject *value_o, *expire_o;
    if (!PyArg_ParseTuple(args, "s#pOOd", &path, &plen, &is_dir, &value_o,
                          &expire_o, &now))
        return NULL;
    double expire;
    if (parse_value(value_o, &value, &vlen) < 0 ||
        parse_expire(expire_o, &expire) < 0)
        return NULL;
    PyObject *nd, *pd;
    uint64_t next = set_apply(c, path, plen, value, vlen, is_dir, expire,
                              now, &nd, &pd);
    if (next == 0)
        return NULL;
    return result3(nd, pd, next);
}

/* Per-op scratch for set_many's three phases. */
typedef struct {
    const char *path, *value;   /* borrowed from the arg lists (alive) */
    Py_ssize_t plen, vlen;
    uint64_t idx;               /* applied index; 0 = this op failed */
    char *pv;                   /* malloc'd copy of the prev value */
    Py_ssize_t pvlen;
    uint64_t pcr, pmo;          /* prev created/modified */
    double pex;                 /* prev expire (NAN = permanent) */
    uint8_t had_prev, need;
    int code;                   /* etcd error code when idx == 0 */
    const char *cause;          /* error cause (stable for the batch) */
    Py_ssize_t clen;
    uint64_t eidx;              /* current_index at failure time */
} SetOp;

/* Build a 6-tuple desc from captured fields (same shape as node_desc).
 * A plain-file SET's nd is fully derivable from its inputs
 * (created = modified = idx, no TTL), so the batch phase never has to
 * hold node pointers across later ops that may overwrite them. */
static PyObject *
desc_from(const char *key, Py_ssize_t klen, const char *val,
          Py_ssize_t vlen, uint64_t created, uint64_t modified,
          double expire)
{
    PyObject *ex;
    if (isnan(expire)) {
        ex = Py_None;
        Py_INCREF(ex);
    } else {
        ex = PyFloat_FromDouble(expire);
        if (ex == NULL)
            return NULL;
    }
    PyObject *t = Py_BuildValue("(s#s#OKKO)", key, klen, val, vlen,
                                Py_False, (unsigned long long)created,
                                (unsigned long long)modified, ex);
    Py_DECREF(ex);
    return t;
}

/* Batched plain-file SETs for the engine apply loop: paths/values are
 * equal-length lists of str, no TTL, no dirs. Runs in three phases:
 *   1. GIL held: parse every path/value/need item up front (a non-str
 *      item fails the whole batch BEFORE any mutation).
 *   2. GIL RELEASED, per-core mutex held: the pure-C mutation loop.
 *      This is the phase that lets K applier shards (disjoint tenant
 *      cores) apply in true parallel on a multi-core box.
 *   3. GIL reacquired, mutex STILL held: build desc tuples and ring
 *      records for the applied prefix — holding the mutex through the
 *      history tail means no reader ever observes current_index
 *      advanced ahead of the ring (a watch registering mid-batch would
 *      otherwise scan past events that "already happened").
 * Per-op etcd errors (e.g. set over a dir) fail THAT op exactly as the
 * scalar call would — stats counted, index unmoved — and the batch
 * continues; only fatal errors (OOM, a non-str item) abort. CONTRACT
 * on a fatal abort: ops before the failing one HAVE been applied and
 * current_index HAS advanced, and the exception does not say how far —
 * the caller must treat it as fatal to the apply loop and HALT (the
 * engine applier fail-stops and re-raises, server/engine.py
 * _applier_loop; recovery is WAL replay, which re-applies the span
 * deterministically). Continuing past it would diverge replicas on a
 * nondeterministic failure (e.g. OOM on one member only).
 * Returns (first_index, last_index, n_failed, recs, descs):
 *   recs  — [(nd, pd|None, index)] per applied op when want_recs (so a
 *           watcher fan-out can notify without rescanning the ring),
 *           else None.
 *   descs — when `need` (a sequence of op positions) is given, one
 *           entry per requested position: (pos, nd, pd|None, index) for
 *           an applied op, (pos, None, (code, cause), index_at_failure)
 *           for a per-op etcd failure. This is the descriptor-based
 *           waiter wake: the applier hands these raw C descriptors to
 *           the wait registry and the HTTP thread materializes the
 *           Event/JSON. None when `need` is None.
 * first > last when nothing applied. */
static PyObject *
Core_set_many(CoreObject *c, PyObject *args)
{
    PyObject *paths, *vals, *need_o = Py_None;
    double now;
    int want_recs = 0;
    if (!PyArg_ParseTuple(args, "O!O!d|pO", &PyList_Type, &paths,
                          &PyList_Type, &vals, &now, &want_recs, &need_o))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(paths);
    if (PyList_GET_SIZE(vals) != n) {
        PyErr_SetString(PyExc_ValueError, "paths/values length mismatch");
        return NULL;
    }
    SetOp *ops = (SetOp *)calloc(n ? n : 1, sizeof(SetOp));
    if (ops == NULL)
        return PyErr_NoMemory();
    /* -- phase 1 (GIL): parse everything up front */
    for (Py_ssize_t i = 0; i < n; i++) {
        ops[i].path = PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(paths, i),
                                              &ops[i].plen);
        ops[i].value = PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(vals, i),
                                               &ops[i].vlen);
        if (ops[i].path == NULL || ops[i].value == NULL) {
            free(ops);
            return NULL;
        }
    }
    if (need_o != Py_None) {
        PyObject *seq = PySequence_Fast(need_o, "need must be a sequence");
        if (seq == NULL) {
            free(ops);
            return NULL;
        }
        Py_ssize_t m = PySequence_Fast_GET_SIZE(seq);
        for (Py_ssize_t i = 0; i < m; i++) {
            Py_ssize_t pos = PyLong_AsSsize_t(
                PySequence_Fast_GET_ITEM(seq, i));
            if (pos == -1 && PyErr_Occurred()) {
                Py_DECREF(seq);
                free(ops);
                return NULL;
            }
            if (pos < 0 || pos >= n) {
                Py_DECREF(seq);
                free(ops);
                PyErr_SetString(PyExc_IndexError,
                                "need position out of range");
                return NULL;
            }
            ops[pos].need = 1;
        }
        Py_DECREF(seq);
    }
    uint64_t first = 0;
    Py_ssize_t failed = 0;
    Py_ssize_t fatal = -1;  /* op index where an OOM abort hit */
    /* -- phase 2 (no GIL, mutex held): pure-C mutations */
    Py_BEGIN_ALLOW_THREADS
    PyThread_acquire_lock(c->mux, WAIT_LOCK);
    first = c->current_index + 1;
    for (Py_ssize_t i = 0; i < n; i++) {
        SetOp *op = &ops[i];
        if (core_is_readonly(c, op->path, op->plen)) {
            c->stats[ST_SETS_FAIL]++;
            op->code = ECODE_ROOT_RONLY;
            op->cause = "/";
            op->clen = 1;
            op->eidx = c->current_index;
            failed++;
            continue;
        }
        uint64_t next = c->current_index + 1;
        Py_ssize_t dlen, nlen;
        const char *name;
        split_dirname(op->path, op->plen, &dlen, &name, &nlen);
        int ecode = 0;
        const char *cz = NULL;
        Py_ssize_t cl = 0;
        CNode *parent = core_make_dirs_c(c, op->path, dlen, next, &ecode,
                                         &cz, &cl);
        if (parent == NULL) {
            c->stats[ST_SETS_FAIL]++;
            if (ecode == -1) {
                fatal = i;
                break;
            }
            op->code = ecode;
            op->cause = cz;
            op->clen = cl;
            op->eidx = c->current_index;
            failed++;
            continue;
        }
        CNode *existing = cmap_get(parent->children, name,
                                   (uint32_t)nlen);
        if (existing != NULL && existing->children != NULL) {
            /* set over a dir: 102 */
            c->stats[ST_SETS_FAIL]++;
            op->code = ECODE_NOT_FILE;
            op->cause = op->path;
            op->clen = op->plen;
            op->eidx = c->current_index;
            failed++;
            continue;
        }
        if (existing != NULL) {
            /* snapshot prev BEFORE the in-place overwrite (the desc
             * tuple is built in phase 3, under the GIL) */
            op->pv = (char *)malloc(existing->value_len + 1);
            if (op->pv == NULL) {
                fatal = i;
                break;
            }
            memcpy(op->pv, existing->value, existing->value_len + 1);
            op->pvlen = existing->value_len;
            op->pcr = existing->created;
            op->pmo = existing->modified;
            op->pex = existing->expire;
            op->had_prev = 1;
            if (node_set_value(existing, op->value, op->vlen) < 0) {
                fatal = i;
                break;
            }
            /* a SET is a brand-new node: both indices move; a stale
             * TTL-heap entry invalidates lazily (heap_top) */
            existing->created = existing->modified = next;
            existing->expire = NAN;
        } else {
            CNode *nn = node_new(op->path, (uint32_t)op->plen, next, next,
                                 parent, op->value, op->vlen, 0, NAN);
            if (nn == NULL || cmap_add(parent->children, nn) < 0) {
                if (nn)
                    node_decref(nn);
                fatal = i;
                break;
            }
        }
        /* no heap_push: set_many never carries a TTL */
        c->current_index = next;
        c->stats[ST_SETS_OK]++;
        op->idx = next;
    }
    Py_END_ALLOW_THREADS
    /* -- phase 3 (GIL + mutex): descs/recs/ring for the applied prefix */
    PyObject *recs = NULL, *descs = NULL, *ret = NULL;
    if (want_recs) {
        recs = PyList_New(0);
        if (recs == NULL)
            goto done;
    }
    if (need_o != Py_None) {
        descs = PyList_New(0);
        if (descs == NULL)
            goto done;
    }
    {
        Py_ssize_t lim = fatal >= 0 ? fatal : n;
        for (Py_ssize_t i = 0; i < lim; i++) {
            SetOp *op = &ops[i];
            if (op->idx == 0) {
                if (op->need) {
                    PyObject *d = Py_BuildValue(
                        "(nO(is#)K)", i, Py_None, op->code, op->cause,
                        op->clen, (unsigned long long)op->eidx);
                    if (d == NULL || PyList_Append(descs, d) < 0) {
                        Py_XDECREF(d);
                        goto done;
                    }
                    Py_DECREF(d);
                }
                continue;
            }
            if (!op->need && recs == NULL && c->ring_cap == 0)
                continue;
            PyObject *nd = desc_from(op->path, op->plen, op->value,
                                     op->vlen, op->idx, op->idx, NAN);
            if (nd == NULL)
                goto done;
            PyObject *pd = NULL;
            if (op->had_prev) {
                pd = desc_from(op->path, op->plen, op->pv, op->pvlen,
                               op->pcr, op->pmo, op->pex);
                if (pd == NULL) {
                    Py_DECREF(nd);
                    goto done;
                }
            }
            ring_push(c, ACT_SET, nd, pd, op->idx, now);
            if (recs != NULL) {
                PyObject *rec = Py_BuildValue(
                    "(OOK)", nd, pd == NULL ? Py_None : pd,
                    (unsigned long long)op->idx);
                if (rec == NULL || PyList_Append(recs, rec) < 0) {
                    Py_XDECREF(rec);
                    Py_DECREF(nd);
                    Py_XDECREF(pd);
                    goto done;
                }
                Py_DECREF(rec);
            }
            if (op->need) {
                PyObject *d = Py_BuildValue(
                    "(nOOK)", i, nd, pd == NULL ? Py_None : pd,
                    (unsigned long long)op->idx);
                if (d == NULL || PyList_Append(descs, d) < 0) {
                    Py_XDECREF(d);
                    Py_DECREF(nd);
                    Py_XDECREF(pd);
                    goto done;
                }
                Py_DECREF(d);
            }
            Py_DECREF(nd);
            Py_XDECREF(pd);
        }
    }
    if (fatal >= 0) {
        PyErr_NoMemory();
        goto done;
    }
    ret = Py_BuildValue(
        "(KKnOO)", (unsigned long long)first,
        (unsigned long long)c->current_index, failed,
        recs == NULL ? Py_None : recs,
        descs == NULL ? Py_None : descs);
done:
    core_unlock(c);
    Py_XDECREF(recs);
    Py_XDECREF(descs);
    for (Py_ssize_t i = 0; i < n; i++)
        free(ops[i].pv);
    free(ops);
    return ret;
}

/* ------------------------------------------------------------ create op */

static PyObject *
Core_create(CoreObject *c, PyObject *args)
{
    const char *path, *value;
    Py_ssize_t plen, vlen;
    int is_dir;
    double now;
    PyObject *value_o, *expire_o;
    if (!PyArg_ParseTuple(args, "s#pOOd", &path, &plen, &is_dir, &value_o,
                          &expire_o, &now))
        return NULL;
    double expire;
    if (parse_value(value_o, &value, &vlen) < 0 ||
        parse_expire(expire_o, &expire) < 0)
        return NULL;
    if (core_is_readonly(c, path, plen)) {
        c->stats[ST_CREATE_FAIL]++;
        raise_etcd(ECODE_ROOT_RONLY, "/", 1, c->current_index);
        return NULL;
    }
    uint64_t next = c->current_index + 1;
    Py_ssize_t dlen, nlen;
    const char *name;
    split_dirname(path, plen, &dlen, &name, &nlen);
    CNode *parent = core_make_dirs(c, path, dlen, next);
    if (parent == NULL) {
        c->stats[ST_CREATE_FAIL]++;
        return NULL;
    }
    if (cmap_get(parent->children, name, (uint32_t)nlen) != NULL) {
        c->stats[ST_CREATE_FAIL]++;
        raise_etcd(ECODE_NODE_EXIST, path, plen, c->current_index);
        return NULL;
    }
    CNode *n = node_new(path, (uint32_t)plen, next, next, parent, value,
                        vlen, is_dir, expire);
    if (n == NULL || cmap_add(parent->children, n) < 0) {
        if (n)
            node_decref(n);
        return PyErr_NoMemory();
    }
    if (heap_push(c, n) < 0)
        return PyErr_NoMemory();
    c->current_index = next;
    c->stats[ST_CREATE_OK]++;
    PyObject *nd = node_desc(n);
    if (nd == NULL)
        return NULL;
    ring_push(c, ACT_CREATE, nd, NULL, next, now);
    return result3(nd, NULL, next);
}

/* ------------------------------------------------------------ update op */

static PyObject *
Core_update(CoreObject *c, PyObject *args)
{
    const char *path, *value;
    Py_ssize_t plen, vlen;
    int refresh;
    double now;
    PyObject *value_o, *expire_o;
    if (!PyArg_ParseTuple(args, "s#OpOd", &path, &plen, &value_o, &refresh,
                          &expire_o, &now))
        return NULL;
    double expire;
    if (parse_value(value_o, &value, &vlen) < 0 ||
        parse_expire(expire_o, &expire) < 0)
        return NULL;
    if (core_is_readonly(c, path, plen)) {
        c->stats[ST_UPDATE_FAIL]++;
        raise_etcd(ECODE_ROOT_RONLY, "/", 1, c->current_index);
        return NULL;
    }
    CNode *n = core_walk(c, path, plen);
    if (n == NULL) {
        c->stats[ST_UPDATE_FAIL]++;
        return NULL;
    }
    PyObject *prev = node_desc(n);
    if (prev == NULL)
        return NULL;
    uint64_t next = c->current_index + 1;
    if (n->children != NULL && value != NULL && vlen > 0) {
        Py_DECREF(prev);
        c->stats[ST_UPDATE_FAIL]++;
        raise_etcd(ECODE_NOT_FILE, path, plen, c->current_index);
        return NULL;
    }
    if (n->children == NULL) {
        if (!refresh) {
            if (node_set_value(n, value ? value : "", value ? vlen : 0)
                    < 0) {
                Py_DECREF(prev);
                return PyErr_NoMemory();
            }
        }
        n->modified = next;
    } else {
        n->modified = next;
    }
    n->expire = expire;
    if (heap_push(c, n) < 0) {
        Py_DECREF(prev);
        return PyErr_NoMemory();
    }
    c->current_index = next;
    c->stats[ST_UPDATE_OK]++;
    PyObject *nd = node_desc(n);
    if (nd == NULL) {
        Py_DECREF(prev);
        return NULL;
    }
    if (!refresh) /* refresh is watcher-silent: not recorded (store.py) */
        ring_push(c, ACT_UPDATE, nd, prev, next, now);
    return result3(nd, prev, next);
}

/* ----------------------------------------------------------- cas/cad op */

/* 0 = pass; on fail raises 101 with the reference's cause format. */
static int
check_compare(CoreObject *c, CNode *n, PyObject *prev_value_o,
              uint64_t prev_index, int fail_stat)
{
    const char *pv = NULL;
    Py_ssize_t pvl = 0;
    if (prev_value_o != Py_None) {
        pv = PyUnicode_AsUTF8AndSize(prev_value_o, &pvl);
        if (pv == NULL)
            return -1;
    }
    int value_ok = (pv == NULL || pvl == 0) ||
        ((Py_ssize_t)n->value_len == pvl &&
         memcmp(n->value, pv, pvl) == 0);
    int index_ok = (prev_index == 0) || (n->modified == prev_index);
    if (value_ok && index_ok)
        return 0;
    c->stats[fail_stat]++;
    char buf[512];
    int len;
    if (value_ok) {
        len = snprintf(buf, sizeof(buf), "[%llu != %llu]",
                       (unsigned long long)prev_index,
                       (unsigned long long)n->modified);
    } else if (index_ok) {
        len = snprintf(buf, sizeof(buf), "[%.*s != %.*s]",
                       (int)pvl, pv ? pv : "",
                       (int)n->value_len, n->value ? n->value : "");
    } else {
        len = snprintf(buf, sizeof(buf), "[%.*s != %.*s] [%llu != %llu]",
                       (int)pvl, pv ? pv : "",
                       (int)n->value_len, n->value ? n->value : "",
                       (unsigned long long)prev_index,
                       (unsigned long long)n->modified);
    }
    if (len < 0)
        len = 0;
    if ((size_t)len >= sizeof(buf))
        len = sizeof(buf) - 1;
    raise_etcd(ECODE_TEST_FAILED, buf, len, c->current_index);
    return -1;
}

static PyObject *
Core_cas(CoreObject *c, PyObject *args)
{
    const char *path, *value;
    Py_ssize_t plen, vlen;
    unsigned long long prev_index;
    double now;
    PyObject *prev_value_o, *value_o, *expire_o;
    if (!PyArg_ParseTuple(args, "s#OKOOd", &path, &plen, &prev_value_o,
                          &prev_index, &value_o, &expire_o, &now))
        return NULL;
    double expire;
    if (parse_value(value_o, &value, &vlen) < 0 ||
        parse_expire(expire_o, &expire) < 0)
        return NULL;
    if (core_is_readonly(c, path, plen)) {
        c->stats[ST_CAS_FAIL]++;
        raise_etcd(ECODE_ROOT_RONLY, "/", 1, c->current_index);
        return NULL;
    }
    CNode *n = core_walk(c, path, plen);
    if (n == NULL) {
        c->stats[ST_CAS_FAIL]++;
        return NULL;
    }
    if (n->children != NULL) {
        c->stats[ST_CAS_FAIL]++;
        raise_etcd(ECODE_NOT_FILE, path, plen, c->current_index);
        return NULL;
    }
    if (check_compare(c, n, prev_value_o, prev_index, ST_CAS_FAIL) < 0)
        return NULL;
    PyObject *prev = node_desc(n);
    if (prev == NULL)
        return NULL;
    uint64_t next = c->current_index + 1;
    if (node_set_value(n, value ? value : "", value ? vlen : 0) < 0) {
        Py_DECREF(prev);
        return PyErr_NoMemory();
    }
    n->modified = next;
    n->expire = expire;
    if (heap_push(c, n) < 0) {
        Py_DECREF(prev);
        return PyErr_NoMemory();
    }
    c->current_index = next;
    c->stats[ST_CAS_OK]++;
    PyObject *nd = node_desc(n);
    if (nd == NULL) {
        Py_DECREF(prev);
        return NULL;
    }
    ring_push(c, ACT_CAS, nd, prev, next, now);
    return result3(nd, prev, next);
}

static PyObject *
Core_cad(CoreObject *c, PyObject *args)
{
    const char *path;
    Py_ssize_t plen;
    unsigned long long prev_index;
    double now;
    PyObject *prev_value_o;
    if (!PyArg_ParseTuple(args, "s#OKd", &path, &plen, &prev_value_o,
                          &prev_index, &now))
        return NULL;
    CNode *n = core_walk(c, path, plen);
    if (n == NULL) {
        c->stats[ST_CAD_FAIL]++;
        return NULL;
    }
    if (n->children != NULL) {
        c->stats[ST_CAD_FAIL]++;
        raise_etcd(ECODE_NOT_FILE, path, plen, c->current_index);
        return NULL;
    }
    if (check_compare(c, n, prev_value_o, prev_index, ST_CAD_FAIL) < 0)
        return NULL;
    PyObject *prev = node_desc(n);
    if (prev == NULL)
        return NULL;
    uint64_t next = c->current_index + 1;
    uint64_t created = n->created;
    if (node_remove_rec(n, NULL) < 0) {
        Py_DECREF(prev);
        return NULL;
    }
    c->current_index = next;
    c->stats[ST_CAD_OK]++;
    /* cad's node view: key + indices only (no dir flag — store.py:341) */
    PyObject *nd = Py_BuildValue("(s#OOKK O)", path, plen, Py_None,
                                 Py_False, (unsigned long long)created,
                                 (unsigned long long)next, Py_None);
    if (nd == NULL) {
        Py_DECREF(prev);
        return NULL;
    }
    ring_push(c, ACT_CAD, nd, prev, next, now);
    return result3(nd, prev, next);
}

/* ------------------------------------------------------------ delete op */

static PyObject *
Core_delete(CoreObject *c, PyObject *args)
{
    const char *path;
    Py_ssize_t plen;
    int is_dir, recursive, want_paths;
    double now;
    if (!PyArg_ParseTuple(args, "s#pppd", &path, &plen, &is_dir, &recursive,
                          &want_paths, &now))
        return NULL;
    if (core_is_readonly(c, path, plen)) {
        c->stats[ST_DELETE_FAIL]++;
        raise_etcd(ECODE_ROOT_RONLY, "/", 1, c->current_index);
        return NULL;
    }
    if (recursive)
        is_dir = 1;
    CNode *n = core_walk(c, path, plen);
    if (n == NULL) {
        c->stats[ST_DELETE_FAIL]++;
        return NULL;
    }
    /* validate before mutating (node.go Remove). These raises originate
     * in node.remove() in the Python store, which passes no index — the
     * error carries index 0, and the HTTP layer serializes it; stay
     * bug-compatible. */
    if (n->children != NULL) {
        if (!is_dir) {
            c->stats[ST_DELETE_FAIL]++;
            raise_etcd(ECODE_NOT_FILE, n->path, n->path_len, 0);
            return NULL;
        }
        if (!recursive && n->children->nused > 0) {
            c->stats[ST_DELETE_FAIL]++;
            raise_etcd(ECODE_DIR_NOT_EMPTY, n->path, n->path_len, 0);
            return NULL;
        }
    }
    PyObject *prev = node_desc(n);
    if (prev == NULL)
        return NULL;
    uint64_t next = c->current_index + 1;
    uint64_t created = n->created;
    int was_dir = n->children != NULL;
    PyObject *removed = NULL;
    if (want_paths) {
        removed = PyList_New(0);
        if (removed == NULL) {
            Py_DECREF(prev);
            return NULL;
        }
    }
    if (node_remove_rec(n, removed) < 0) {
        Py_DECREF(prev);
        Py_XDECREF(removed);
        return NULL;
    }
    c->current_index = next;
    c->stats[ST_DELETE_OK]++;
    /* delete's node view includes the dir flag (store.py:311-313) */
    PyObject *nd = Py_BuildValue("(s#OOKK O)", path, plen, Py_None,
                                 was_dir ? Py_True : Py_False,
                                 (unsigned long long)created,
                                 (unsigned long long)next, Py_None);
    if (nd == NULL) {
        Py_DECREF(prev);
        Py_XDECREF(removed);
        return NULL;
    }
    ring_push(c, ACT_DELETE, nd, prev, next, now);
    PyObject *r3 = result3(nd, prev, next);
    if (r3 == NULL) {
        Py_XDECREF(removed);
        return NULL;
    }
    if (removed == NULL) {
        removed = Py_None;
        Py_INCREF(removed);
    }
    PyObject *out = PyTuple_New(2);
    if (out == NULL) {
        Py_DECREF(r3);
        Py_DECREF(removed);
        return NULL;
    }
    PyTuple_SET_ITEM(out, 0, r3);
    PyTuple_SET_ITEM(out, 1, removed);
    return out;
}

/* ------------------------------------------------------------ expire op */

static PyObject *
Core_expire_keys(CoreObject *c, PyObject *args)
{
    double cutoff;
    if (!PyArg_ParseTuple(args, "d", &cutoff))
        return NULL;
    PyObject *out = PyList_New(0);
    if (out == NULL)
        return NULL;
    for (;;) {
        CNode *n = heap_top(c);
        if (n == NULL || n->expire > cutoff)
            break;
        heap_pop(c);
        c->current_index++;
        PyObject *prev = node_desc(n);
        PyObject *removed = PyList_New(0);
        PyObject *nd = Py_BuildValue(
            "(s#OOKK O)", n->path, (Py_ssize_t)n->path_len, Py_None,
            n->children != NULL ? Py_True : Py_False,
            (unsigned long long)n->created,
            (unsigned long long)c->current_index, Py_None);
        if (!prev || !removed || !nd ||
            node_remove_rec(n, removed) < 0) {
            Py_XDECREF(prev); Py_XDECREF(removed); Py_XDECREF(nd);
            Py_DECREF(out);
            return NULL;
        }
        c->stats[ST_EXPIRE]++;
        ring_push(c, ACT_EXPIRE, nd, prev, c->current_index, cutoff);
        PyObject *item = Py_BuildValue(
            "(NNNK)", nd, prev, removed,
            (unsigned long long)c->current_index);
        if (item == NULL || PyList_Append(out, item) < 0) {
            Py_XDECREF(item);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(item);
    }
    return out;
}

static PyObject *
Core_next_expiration(CoreObject *c, PyObject *Py_UNUSED(ignored))
{
    CNode *n = heap_top(c);
    if (n == NULL)
        Py_RETURN_NONE;
    return PyFloat_FromDouble(n->expire);
}

/* ------------------------------------------------------- history scan */

#define EC_EVENT_INDEX_CLEARED 401

/* First recorded event with index >= since touching `key` (or its
 * subtree when recursive) — reference event_history.go:58-105. Returns
 * (action, nd, pd, index, now) or None; raises 401 when `since`
 * predates the retained window. */
static PyObject *
Core_scan(CoreObject *c, PyObject *args)
{
    const char *key;
    Py_ssize_t klen;
    int recursive;
    unsigned long long since;
    if (!PyArg_ParseTuple(args, "s#pK", &key, &klen, &recursive, &since))
        return NULL;
    if (c->ring_len == 0)
        Py_RETURN_NONE;
    uint64_t start = c->ring[c->ring_head].index;
    uint64_t last =
        c->ring[(c->ring_head + c->ring_len - 1) % c->ring_cap].index;
    if (since < start) {
        char buf[128];
        int n = snprintf(buf, sizeof(buf),
                         "the requested history has been cleared "
                         "[%llu/%llu]",
                         (unsigned long long)start,
                         (unsigned long long)since);
        raise_etcd(EC_EVENT_INDEX_CLEARED, buf, n, last);
        return NULL;
    }
    Py_ssize_t pfx_len = klen; /* key.rstrip("/") for the subtree match */
    while (pfx_len > 0 && key[pfx_len - 1] == '/')
        pfx_len--;
    for (Py_ssize_t i = 0; i < c->ring_len; i++) {
        RingRec *r = &c->ring[(c->ring_head + i) % c->ring_cap];
        if (r->index < since)
            continue;
        Py_ssize_t el;
        const char *ekey = PyUnicode_AsUTF8AndSize(
            PyTuple_GET_ITEM(r->nd, 0), &el);
        if (ekey == NULL)
            return NULL;
        int match = (el == klen && memcmp(ekey, key, klen) == 0);
        if (!match && recursive && el > pfx_len &&
            memcmp(ekey, key, pfx_len) == 0 && ekey[pfx_len] == '/')
            match = 1;
        if (match)
            return Py_BuildValue("(iOOKd)", r->action, r->nd, r->pd,
                                 (unsigned long long)r->index, r->now);
    }
    Py_RETURN_NONE;
}

static PyObject *
Core_ring_bounds(CoreObject *c, PyObject *Py_UNUSED(ignored))
{
    if (c->ring_len == 0)
        return Py_BuildValue("(KKn)", 0ULL, 0ULL, (Py_ssize_t)0);
    uint64_t start = c->ring[c->ring_head].index;
    uint64_t last =
        c->ring[(c->ring_head + c->ring_len - 1) % c->ring_cap].index;
    return Py_BuildValue("(KKn)", (unsigned long long)start,
                         (unsigned long long)last, c->ring_len);
}

/* --------------------------------------------------------------- get op */

/* Builds the 7-tuple tree: desc + (children|None,). Children are
 * materialized at the top level always, deeper only when recursive;
 * hidden children are excluded at every materialized level; sorted
 * orders by path (node.py as_extern). */
static PyObject *
build_tree(const CNode *n, int recursive, int want_sorted, int materialize)
{
    PyObject *desc = node_desc(n);
    if (desc == NULL)
        return NULL;
    PyObject *kids = NULL;
    if (n->children != NULL && materialize) {
        uint32_t cnt = 0;
        for (uint32_t i = 0; i < n->children->norder; i++) {
            CNode *ch = n->children->order[i];
            if (ch != NULL && !ch->hidden)
                cnt++;
        }
        CNode **arr = NULL;
        if (cnt > 0) {
            arr = (CNode **)malloc(cnt * sizeof(CNode *));
            if (arr == NULL) {
                Py_DECREF(desc);
                return PyErr_NoMemory();
            }
            uint32_t w = 0;
            for (uint32_t i = 0; i < n->children->norder; i++) {
                CNode *ch = n->children->order[i];
                if (ch != NULL && !ch->hidden)
                    arr[w++] = ch;
            }
            if (want_sorted) {
                /* insertion sort by path: dirs are small, order is
                 * near-sorted in practice */
                for (uint32_t i = 1; i < cnt; i++) {
                    CNode *key = arr[i];
                    uint32_t j = i;
                    while (j > 0 &&
                           strcmp(arr[j - 1]->path, key->path) > 0) {
                        arr[j] = arr[j - 1];
                        j--;
                    }
                    arr[j] = key;
                }
            }
        }
        kids = PyTuple_New(cnt);
        if (kids == NULL) {
            free(arr);
            Py_DECREF(desc);
            return NULL;
        }
        for (uint32_t i = 0; i < cnt; i++) {
            PyObject *sub = build_tree(arr[i], recursive, want_sorted,
                                       recursive);
            if (sub == NULL) {
                free(arr);
                Py_DECREF(kids);
                Py_DECREF(desc);
                return NULL;
            }
            PyTuple_SET_ITEM(kids, i, sub);
        }
        free(arr);
    }
    if (kids == NULL) {
        kids = Py_None;
        Py_INCREF(kids);
    }
    /* extend desc to a 7-tuple */
    PyObject *t = PyTuple_New(7);
    if (t == NULL) {
        Py_DECREF(desc);
        Py_DECREF(kids);
        return NULL;
    }
    for (int i = 0; i < 6; i++) {
        PyObject *o = PyTuple_GET_ITEM(desc, i);
        Py_INCREF(o);
        PyTuple_SET_ITEM(t, i, o);
    }
    PyTuple_SET_ITEM(t, 6, kids);
    Py_DECREF(desc);
    return t;
}

static PyObject *
Core_get(CoreObject *c, PyObject *args)
{
    const char *path;
    Py_ssize_t plen;
    int recursive, want_sorted;
    if (!PyArg_ParseTuple(args, "s#pp", &path, &plen, &recursive,
                          &want_sorted))
        return NULL;
    CNode *n = core_walk(c, path, plen);
    if (n == NULL) {
        c->stats[ST_GETS_FAIL]++;
        return NULL;
    }
    PyObject *t = build_tree(n, recursive, want_sorted, 1);
    if (t == NULL)
        return NULL;
    c->stats[ST_GETS_OK]++;
    /* (tree, index) in ONE atomic call: reading the index in a second
     * call could pair a newer index with an older snapshot, breaking
     * the GET-then-watch(waitIndex=X+1) no-missed-events contract. */
    return Py_BuildValue("(NK)", t,
                         (unsigned long long)c->current_index);
}

/* ------------------------------------------------------- dump/load/clone */

/* Full tree incl. hidden nodes, children always materialized, insertion
 * order — the JSON snapshot shape (node.py to_json). */
static PyObject *
dump_tree(const CNode *n)
{
    PyObject *desc = node_desc(n);
    if (desc == NULL)
        return NULL;
    PyObject *kids;
    if (n->children != NULL) {
        uint32_t cnt = 0;
        for (uint32_t i = 0; i < n->children->norder; i++)
            if (n->children->order[i] != NULL)
                cnt++;
        kids = PyTuple_New(cnt);
        if (kids == NULL) {
            Py_DECREF(desc);
            return NULL;
        }
        uint32_t w = 0;
        for (uint32_t i = 0; i < n->children->norder; i++) {
            CNode *ch = n->children->order[i];
            if (ch == NULL)
                continue;
            PyObject *sub = dump_tree(ch);
            if (sub == NULL) {
                Py_DECREF(kids);
                Py_DECREF(desc);
                return NULL;
            }
            PyTuple_SET_ITEM(kids, w++, sub);
        }
    } else {
        kids = Py_None;
        Py_INCREF(kids);
    }
    PyObject *t = PyTuple_New(7);
    if (t == NULL) {
        Py_DECREF(desc);
        Py_DECREF(kids);
        return NULL;
    }
    for (int i = 0; i < 6; i++) {
        PyObject *o = PyTuple_GET_ITEM(desc, i);
        Py_INCREF(o);
        PyTuple_SET_ITEM(t, i, o);
    }
    PyTuple_SET_ITEM(t, 6, kids);
    Py_DECREF(desc);
    return t;
}

static PyObject *
Core_dump(CoreObject *c, PyObject *Py_UNUSED(ignored))
{
    return dump_tree(c->root);
}

/* Rebuild a node (and heap entries) from the 7-tuple shape. */
static CNode *
load_tree(CoreObject *c, PyObject *t, CNode *parent)
{
    const char *path, *value = NULL;
    Py_ssize_t plen, vlen = 0;
    PyObject *value_o = PyTuple_GET_ITEM(t, 1);
    PyObject *expire_o = PyTuple_GET_ITEM(t, 5);
    PyObject *kids = PyTuple_GET_ITEM(t, 6);
    path = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(t, 0), &plen);
    if (path == NULL)
        return NULL;
    int is_dir = PyObject_IsTrue(PyTuple_GET_ITEM(t, 2));
    uint64_t created =
        PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(t, 3));
    uint64_t modified =
        PyLong_AsUnsignedLongLong(PyTuple_GET_ITEM(t, 4));
    if (PyErr_Occurred())
        return NULL;
    double expire;
    if (parse_expire(expire_o, &expire) < 0)
        return NULL;
    if (value_o != Py_None) {
        value = PyUnicode_AsUTF8AndSize(value_o, &vlen);
        if (value == NULL)
            return NULL;
    }
    CNode *n = node_new(path, (uint32_t)plen, created, modified, parent,
                        value, vlen, is_dir, expire);
    if (n == NULL) {
        PyErr_NoMemory();
        return NULL;
    }
    if (heap_push(c, n) < 0) {
        node_decref(n);
        PyErr_NoMemory();
        return NULL;
    }
    if (is_dir && kids != Py_None) {
        Py_ssize_t cnt = PyTuple_GET_SIZE(kids);
        for (Py_ssize_t i = 0; i < cnt; i++) {
            CNode *ch = load_tree(c, PyTuple_GET_ITEM(kids, i), n);
            if (ch == NULL || cmap_add(n->children, ch) < 0) {
                if (ch)
                    node_decref(ch);
                node_decref(n);
                return NULL;
            }
        }
    }
    return n;
}

static PyObject *
Core_load(CoreObject *c, PyObject *args)
{
    PyObject *t;
    if (!PyArg_ParseTuple(args, "O!", &PyTuple_Type, &t))
        return NULL;
    /* reset heap + tree */
    while (c->heap_len > 0)
        heap_pop(c);
    CNode *root = load_tree(c, t, NULL);
    if (root == NULL) {
        /* drop heap refs to the partially built tree */
        while (c->heap_len > 0)
            heap_pop(c);
        return NULL;
    }
    node_decref(c->root);
    c->root = root;
    Py_RETURN_NONE;
}

static CNode *
clone_tree(CoreObject *dst, const CNode *n, CNode *parent)
{
    CNode *m = node_new(n->path, n->path_len, n->created, n->modified,
                        parent, n->value, n->value_len,
                        n->children != NULL, n->expire);
    if (m == NULL) {
        PyErr_NoMemory();
        return NULL;
    }
    if (heap_push(dst, m) < 0) {
        node_decref(m);
        PyErr_NoMemory();
        return NULL;
    }
    if (n->children != NULL) {
        for (uint32_t i = 0; i < n->children->norder; i++) {
            CNode *ch = n->children->order[i];
            if (ch == NULL)
                continue;
            CNode *cm = clone_tree(dst, ch, m);
            if (cm == NULL || cmap_add(m->children, cm) < 0) {
                if (cm)
                    node_decref(cm);
                node_decref(m);
                return NULL;
            }
        }
    }
    return m;
}

static PyObject *Core_new_like(CoreObject *c);

static PyObject *
Core_clone(CoreObject *c, PyObject *Py_UNUSED(ignored))
{
    PyObject *o = Core_new_like(c);
    if (o == NULL)
        return NULL;
    CoreObject *d = (CoreObject *)o;
    CNode *root = clone_tree(d, c->root, NULL);
    if (root == NULL) {
        Py_DECREF(o);
        return NULL;
    }
    node_decref(d->root);
    d->root = root;
    d->current_index = c->current_index;
    memcpy(d->stats, c->stats, sizeof(d->stats));
    return o;
}

/* ----------------------------------------------------------- stats etc. */

static PyObject *
Core_stats(CoreObject *c, PyObject *Py_UNUSED(ignored))
{
    PyObject *t = PyTuple_New(NSTATS);
    if (t == NULL)
        return NULL;
    for (int i = 0; i < NSTATS; i++) {
        PyObject *v = PyLong_FromLongLong(c->stats[i]);
        if (v == NULL) {
            Py_DECREF(t);
            return NULL;
        }
        PyTuple_SET_ITEM(t, i, v);
    }
    return t;
}

static PyObject *
Core_set_stats(CoreObject *c, PyObject *args)
{
    PyObject *t;
    if (!PyArg_ParseTuple(args, "O!", &PyTuple_Type, &t))
        return NULL;
    if (PyTuple_GET_SIZE(t) != NSTATS) {
        PyErr_SetString(PyExc_ValueError, "stats tuple size");
        return NULL;
    }
    for (int i = 0; i < NSTATS; i++) {
        long long v = PyLong_AsLongLong(PyTuple_GET_ITEM(t, i));
        if (v == -1 && PyErr_Occurred())
            return NULL;
        c->stats[i] = v;
    }
    Py_RETURN_NONE;
}

static PyObject *
Core_get_index(CoreObject *c, void *closure)
{
    core_lock(c);
    PyObject *r = PyLong_FromUnsignedLongLong(c->current_index);
    core_unlock(c);
    return r;
}

static int
Core_set_index(CoreObject *c, PyObject *v, void *closure)
{
    unsigned long long x = PyLong_AsUnsignedLongLong(v);
    if (x == (unsigned long long)-1 && PyErr_Occurred())
        return -1;
    core_lock(c);
    c->current_index = x;
    core_unlock(c);
    return 0;
}

/* Locked entry points (see core_lock): everything that touches the
 * tree/heap/ring/stats must exclude set_many's GIL-free batch phase.
 * set_many itself manages the mutex around its phases. */
LOCKED(Core_set)
LOCKED(Core_create)
LOCKED(Core_update)
LOCKED(Core_cas)
LOCKED(Core_cad)
LOCKED(Core_delete)
LOCKED(Core_expire_keys)
LOCKED(Core_next_expiration)
LOCKED(Core_scan)
LOCKED(Core_ring_bounds)
LOCKED(Core_get)
LOCKED(Core_dump)
LOCKED(Core_load)
LOCKED(Core_clone)
LOCKED(Core_stats)
LOCKED(Core_set_stats)

/* --------------------------------------------------------- construction */

static PyObject *
Core_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    PyObject *namespaces = NULL;
    Py_ssize_t capacity = 1000; /* reference store/store.go:79 */
    static char *kwlist[] = {"namespaces", "history_capacity", NULL};
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "|O!n", kwlist,
                                     &PyTuple_Type, &namespaces, &capacity))
        return NULL;
    CoreObject *c = (CoreObject *)type->tp_alloc(type, 0);
    if (c == NULL)
        return NULL;
    c->mux = PyThread_allocate_lock();
    if (c->mux == NULL) {
        Py_DECREF(c);
        return PyErr_NoMemory();
    }
    if (capacity > 0) {
        c->ring = (RingRec *)calloc(capacity, sizeof(RingRec));
        if (c->ring == NULL) {
            Py_DECREF(c);
            return PyErr_NoMemory();
        }
        c->ring_cap = capacity;
    }
    c->root = node_new("/", 1, 0, 0, NULL, NULL, 0, 1, NAN);
    if (c->root == NULL) {
        Py_DECREF(c);
        return PyErr_NoMemory();
    }
    c->root->name_off = 0; /* name of "/" is "/" (key_name special-case) */
    if (namespaces != NULL) {
        Py_INCREF(namespaces);
        c->namespaces = namespaces;
        Py_ssize_t n = PyTuple_GET_SIZE(namespaces);
        /* C copies so the readonly check runs GIL-free (set_many) */
        c->ns_c = (char **)calloc(n ? n : 1, sizeof(char *));
        c->ns_len = (Py_ssize_t *)calloc(n ? n : 1, sizeof(Py_ssize_t));
        if (c->ns_c == NULL || c->ns_len == NULL) {
            Py_DECREF(c);
            return PyErr_NoMemory();
        }
        for (Py_ssize_t i = 0; i < n; i++) {
            Py_ssize_t nl;
            const char *ns = PyUnicode_AsUTF8AndSize(
                PyTuple_GET_ITEM(namespaces, i), &nl);
            if (ns == NULL) {
                Py_DECREF(c);
                return NULL;
            }
            c->ns_c[i] = (char *)malloc(nl + 1);
            if (c->ns_c[i] == NULL) {
                Py_DECREF(c);
                return PyErr_NoMemory();
            }
            memcpy(c->ns_c[i], ns, nl + 1);
            c->ns_len[i] = nl;
            c->ns_n = i + 1;
            CNode *nn = node_new(ns, (uint32_t)nl, 0, 0, c->root, NULL, 0,
                                 1, NAN);
            if (nn == NULL || cmap_add(c->root->children, nn) < 0) {
                if (nn)
                    node_decref(nn);
                Py_DECREF(c);
                return PyErr_NoMemory();
            }
        }
    }
    return (PyObject *)c;
}

static PyObject *
Core_new_like(CoreObject *c)
{
    PyObject *args = PyTuple_New(0);
    PyObject *kw = PyDict_New();
    PyObject *cap = PyLong_FromSsize_t(c->ring_cap);
    if (args == NULL || kw == NULL || cap == NULL ||
        PyDict_SetItemString(kw, "history_capacity", cap) < 0 ||
        (c->namespaces != NULL &&
         PyDict_SetItemString(kw, "namespaces", c->namespaces) < 0)) {
        Py_XDECREF(args);
        Py_XDECREF(kw);
        Py_XDECREF(cap);
        return NULL;
    }
    Py_DECREF(cap);
    PyObject *o = Core_new(Py_TYPE(c), args, kw);
    Py_DECREF(args);
    Py_DECREF(kw);
    return o;
}

static void
Core_dealloc(CoreObject *c)
{
    while (c->heap_len > 0)
        heap_pop(c);
    free(c->heap);
    for (Py_ssize_t i = 0; i < c->ring_len; i++) {
        RingRec *r = &c->ring[(c->ring_head + i) % c->ring_cap];
        Py_DECREF(r->nd);
        Py_DECREF(r->pd);
    }
    free(c->ring);
    if (c->root != NULL)
        node_decref(c->root);
    Py_XDECREF(c->namespaces);
    for (Py_ssize_t i = 0; i < c->ns_n; i++)
        free(c->ns_c[i]);
    free(c->ns_c);
    free(c->ns_len);
    if (c->mux != NULL)
        PyThread_free_lock(c->mux);
    Py_TYPE(c)->tp_free((PyObject *)c);
}

static PyMethodDef Core_methods[] = {
    {"set", (PyCFunction)Core_set_L, METH_VARARGS,
     "set(path, is_dir, value, expire) -> (desc, prev|None, index)"},
    {"set_many", (PyCFunction)Core_set_many, METH_VARARGS,
     "set_many(paths, values, now, want_recs=False, need=None) -> "
     "(first_index, last_index, n_failed, recs|None, descs|None); "
     "batched plain-file SETs (mutations run with the GIL released "
     "under the per-core mutex), per-op etcd errors skipped; recs = "
     "[(nd, pd|None, index)] when asked; descs = raw descriptors for "
     "the `need` op positions (see the function comment)"},
    {"create", (PyCFunction)Core_create_L, METH_VARARGS,
     "create(path, is_dir, value, expire) -> (desc, None, index)"},
    {"update", (PyCFunction)Core_update_L, METH_VARARGS,
     "update(path, value, refresh, expire) -> (desc, prev, index)"},
    {"cas", (PyCFunction)Core_cas_L, METH_VARARGS,
     "cas(path, prev_value, prev_index, value, expire)"},
    {"cad", (PyCFunction)Core_cad_L, METH_VARARGS,
     "cad(path, prev_value, prev_index)"},
    {"delete", (PyCFunction)Core_delete_L, METH_VARARGS,
     "delete(path, is_dir, recursive, want_paths)"
     " -> ((desc, prev, index), removed|None)"},
    {"expire_keys", (PyCFunction)Core_expire_keys_L, METH_VARARGS,
     "expire_keys(cutoff) -> [(desc, prev, removed, index)]"},
    {"next_expiration", (PyCFunction)Core_next_expiration_L, METH_NOARGS,
     "earliest live expiry or None"},
    {"scan", (PyCFunction)Core_scan_L, METH_VARARGS,
     "scan(key, recursive, since) -> (action, nd, pd, index, now)|None"},
    {"ring_bounds", (PyCFunction)Core_ring_bounds_L, METH_NOARGS,
     "(start_index, last_index, len) of the history ring"},
    {"get", (PyCFunction)Core_get_L, METH_VARARGS,
     "get(path, recursive, sorted) -> 7-tuple tree"},
    {"dump", (PyCFunction)Core_dump_L, METH_NOARGS,
     "full tree as 7-tuples (snapshot shape)"},
    {"load", (PyCFunction)Core_load_L, METH_VARARGS,
     "replace tree from dump() shape"},
    {"clone", (PyCFunction)Core_clone_L, METH_NOARGS, "deep copy"},
    {"stats", (PyCFunction)Core_stats_L, METH_NOARGS, "counter tuple"},
    {"set_stats", (PyCFunction)Core_set_stats_L, METH_VARARGS,
     "replace counters"},
    {NULL}
};

static PyGetSetDef Core_getset[] = {
    {"index", (getter)Core_get_index, (setter)Core_set_index,
     "current_index", NULL},
    {NULL}
};

static PyTypeObject CoreType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "etcd_tpu_torch.native.storecore.Core",
    .tp_basicsize = sizeof(CoreObject),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "native v2 store tree core",
    .tp_new = Core_new,
    .tp_dealloc = (destructor)Core_dealloc,
    .tp_methods = Core_methods,
    .tp_getset = Core_getset,
};

static struct PyModuleDef storecore_module = {
    PyModuleDef_HEAD_INIT, "storecore",
    "native v2 store node-tree core", -1, NULL
};

PyMODINIT_FUNC
PyInit_storecore(void)
{
    PyObject *errmod = PyImport_ImportModule("etcd_tpu_torch.errors");
    if (errmod == NULL)
        return NULL;
    EtcdError = PyObject_GetAttrString(errmod, "EtcdError");
    Py_DECREF(errmod);
    if (EtcdError == NULL)
        return NULL;
    if (PyType_Ready(&CoreType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&storecore_module);
    if (m == NULL)
        return NULL;
    Py_INCREF(&CoreType);
    if (PyModule_AddObject(m, "Core", (PyObject *)&CoreType) < 0) {
        Py_DECREF(&CoreType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}

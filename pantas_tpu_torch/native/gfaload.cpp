// Native GFA -> SplicingGraph loader (CPython extension).
//
// Parses an (augmented) annotated GFA into the structures the pure-Python
// SplicingGraph._from_gfa_py builds (behavioral contract: the reference
// caller, scripts/call.py:132-181): a seg mapping, a link mapping keyed by
// (a, b) string tuples, the annotated/novel junction sets, and the four
// endpoint indexes. The file is scanned with the GIL released (mmap +
// memchr, in threads) into flat tables: an open-addressing id index, each
// link's endpoints, a pair index and CSR adjacency. `seg` and `link` are
// Maps over those tables that build a Seg or Link record on its first
// lookup (a call reads a few percent of them), with the same attribute
// protocol as the Python SegInfo/LinkInfo classes, so every caller-side
// consumer works unchanged.
//
// Set/dict iteration-order parity: the junction sets and indexes are real
// sets and dicts with the Python parser's contents and insertion order, and
// string hashing is the host interpreter's (PYTHONHASHSEED-respecting)
// siphash, so downstream hash-order-dependent row content (reference
// call.py:240,531 semantics) is identical to the pure-Python loader's
// within the same process seed.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <new>
#include <string_view>
#include <system_error>
#include <thread>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// Buf: owns the mmap'd file for the lifetime of lazy tag slices
// ---------------------------------------------------------------------------

typedef struct {
    PyObject_HEAD
    const char *data;
    size_t size;
} BufObj;

static void Buf_dealloc(BufObj *self) {
    if (self->data) munmap((void *)self->data, self->size);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyTypeObject BufType = {
    PyVarObject_HEAD_INIT(NULL, 0)
};

// ---------------------------------------------------------------------------
// Seg type (attribute-compatible with events.caller.SegInfo). The EX tag is
// kept as a (buf, offset, len) slice and materialized to a str only on
// first .ex_raw access — most segments' exon labels are never consulted.
// ---------------------------------------------------------------------------

typedef struct {
    PyObject_HEAD
    PyObject *ex_obj;    // materialized str, explicit assignment, or NULL
    PyObject *nc;        // int or None
    PyObject *incoming;  // list[str]
    PyObject *outgoing;  // list[str]
    PyObject *buf;       // BufObj keeping the lazy slice alive, or NULL
    const char *ex_ptr;  // lazy slice (valid while buf held)
    long ex_len;         // -1 = no EX tag
    long length;
} SegObj;

static void Seg_dealloc(SegObj *self) {
    Py_XDECREF(self->ex_obj);
    Py_XDECREF(self->nc);
    Py_XDECREF(self->incoming);
    Py_XDECREF(self->outgoing);
    Py_XDECREF(self->buf);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *Seg_new(PyTypeObject *type, PyObject *, PyObject *) {
    SegObj *self = (SegObj *)type->tp_alloc(type, 0);
    if (!self) return NULL;
    self->ex_obj = NULL;
    Py_INCREF(Py_None);
    self->nc = Py_None;
    self->length = 0;
    self->buf = NULL;
    self->ex_ptr = NULL;
    self->ex_len = -1;
    self->incoming = PyList_New(0);
    self->outgoing = PyList_New(0);
    if (!self->incoming || !self->outgoing) {
        Py_DECREF(self);
        return NULL;
    }
    return (PyObject *)self;
}

static int Seg_init(SegObj *self, PyObject *args, PyObject *kwds) {
    static const char *kwlist[] = {"length", NULL};
    long length = 0;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "|l", (char **)kwlist, &length))
        return -1;
    self->length = length;
    return 0;
}

static PyObject *Seg_get_ex_raw(SegObj *self, void *) {
    if (self->ex_obj) {
        Py_INCREF(self->ex_obj);
        return self->ex_obj;
    }
    if (self->ex_len < 0) Py_RETURN_NONE;
    self->ex_obj = PyUnicode_FromStringAndSize(self->ex_ptr, self->ex_len);
    if (!self->ex_obj) return NULL;
    Py_INCREF(self->ex_obj);
    return self->ex_obj;
}

static int Seg_set_ex_raw(SegObj *self, PyObject *value, void *) {
    if (!value) value = Py_None;
    Py_INCREF(value);
    Py_XSETREF(self->ex_obj, value);
    self->ex_len = -1;  // explicit assignment overrides the lazy slice
    return 0;
}

static PyGetSetDef Seg_getset[] = {
    {"ex_raw", (getter)Seg_get_ex_raw, (setter)Seg_set_ex_raw, NULL, NULL},
    {NULL, NULL, NULL, NULL, NULL},
};

static PyMemberDef Seg_members[] = {
    {"nc", T_OBJECT, offsetof(SegObj, nc), 0, NULL},
    {"incoming", T_OBJECT, offsetof(SegObj, incoming), 0, NULL},
    {"outgoing", T_OBJECT, offsetof(SegObj, outgoing), 0, NULL},
    {"length", T_LONG, offsetof(SegObj, length), 0, NULL},
    {NULL, 0, 0, 0, NULL},
};

static PyTypeObject SegType = {
    PyVarObject_HEAD_INIT(NULL, 0)
};

// ---------------------------------------------------------------------------
// Link type (attribute-compatible with events.caller.LinkInfo, incl. the
// lazily-split `jn` label-list property)
// ---------------------------------------------------------------------------

typedef struct {
    PyObject_HEAD
    PyObject *rc;      // int or None
    PyObject *jn_obj;  // materialized str, explicit assignment, or NULL
    PyObject *novel;   // bool
    PyObject *jn_list; // cached list or NULL
    PyObject *buf;     // BufObj keeping the lazy slice alive, or NULL
    const char *jn_ptr;
    long jn_len;       // -1 = no JN tag
} LinkObj;

static void Link_dealloc(LinkObj *self) {
    Py_XDECREF(self->rc);
    Py_XDECREF(self->jn_obj);
    Py_XDECREF(self->novel);
    Py_XDECREF(self->jn_list);
    Py_XDECREF(self->buf);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *Link_new(PyTypeObject *type, PyObject *, PyObject *) {
    LinkObj *self = (LinkObj *)type->tp_alloc(type, 0);
    if (!self) return NULL;
    Py_INCREF(Py_None);
    self->rc = Py_None;
    self->jn_obj = NULL;
    Py_INCREF(Py_False);
    self->novel = Py_False;
    self->jn_list = NULL;
    self->buf = NULL;
    self->jn_ptr = NULL;
    self->jn_len = -1;
    return (PyObject *)self;
}

static int Link_init(LinkObj *self, PyObject *args, PyObject *kwds) {
    static const char *kwlist[] = {"rc", "novel", NULL};
    PyObject *rc = Py_None, *novel = Py_False;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "|OO", (char **)kwlist, &rc, &novel))
        return -1;
    Py_INCREF(rc);
    Py_SETREF(self->rc, rc);
    Py_INCREF(novel);
    Py_SETREF(self->novel, novel);
    return 0;
}

static PyObject *Link_get_jn_raw(LinkObj *self, void *) {
    if (self->jn_obj) {
        Py_INCREF(self->jn_obj);
        return self->jn_obj;
    }
    if (self->jn_len < 0) Py_RETURN_NONE;
    self->jn_obj = PyUnicode_FromStringAndSize(self->jn_ptr, self->jn_len);
    if (!self->jn_obj) return NULL;
    Py_INCREF(self->jn_obj);
    return self->jn_obj;
}

static int Link_set_jn_raw(LinkObj *self, PyObject *value, void *) {
    if (!value) value = Py_None;
    Py_INCREF(value);
    Py_XSETREF(self->jn_obj, value);
    self->jn_len = -1;
    Py_CLEAR(self->jn_list);
    return 0;
}

static PyObject *Link_get_jn(LinkObj *self, void *) {
    if (!self->jn_list) {
        PyObject *raw = Link_get_jn_raw(self, NULL);
        if (!raw) return NULL;
        if (raw != Py_None && PyUnicode_GET_LENGTH(raw) > 0) {
            PyObject *comma = PyUnicode_FromStringAndSize(",", 1);
            if (!comma) {
                Py_DECREF(raw);
                return NULL;
            }
            self->jn_list = PyUnicode_Split(raw, comma, -1);
            Py_DECREF(comma);
        } else {
            self->jn_list = PyList_New(0);
        }
        Py_DECREF(raw);
        if (!self->jn_list) return NULL;
    }
    Py_INCREF(self->jn_list);
    return self->jn_list;
}

static PyGetSetDef Link_getset[] = {
    {"jn", (getter)Link_get_jn, NULL, NULL, NULL},
    {"jn_raw", (getter)Link_get_jn_raw, (setter)Link_set_jn_raw, NULL, NULL},
    {NULL, NULL, NULL, NULL, NULL},
};

static PyMemberDef Link_members[] = {
    {"rc", T_OBJECT, offsetof(LinkObj, rc), 0, NULL},
    {"novel", T_OBJECT, offsetof(LinkObj, novel), 0, NULL},
    {NULL, 0, 0, 0, NULL},
};

static PyTypeObject LinkType = {
    PyVarObject_HEAD_INIT(NULL, 0)
};

// ---------------------------------------------------------------------------
// Record index (phase 1, GIL released)
// ---------------------------------------------------------------------------

struct SRec {
    const char *nid;
    int nid_len;
    long seqlen;
    long nc;
    bool has_nc;  // presence flag: NC:i:-1 must load as -1, not None
    const char *ex;
    long ex_len;  // -1 = absent
    const char *line;  // file position, for L-before-S ordering parity
};

struct LRec {
    const char *a;
    int a_len;
    const char *b;
    int b_len;
    long rc;
    bool has_rc;  // presence flag (negative RC values are representable)
    const char *jn;
    long jn_len;  // -1 = absent
    bool novel;
    const char *line;
};

static inline const char *next_tab(const char *p, const char *end) {
    const char *t = (const char *)memchr(p, '\t', end - p);
    return t ? t : end;
}

static inline long parse_long(const char *p, const char *end) {
    long v = 0;
    bool neg = false;
    if (p < end && *p == '-') {
        neg = true;
        ++p;
    }
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    return neg ? -v : v;
}

static void scan_records(const char *data, size_t size, std::vector<SRec> &ss,
                         std::vector<LRec> &ls) {
    const char *p = data;
    const char *end = data + size;
    while (p < end) {
        const char *nl = (const char *)memchr(p, '\n', end - p);
        const char *eol = nl ? nl : end;
        char c = *p;
        if (c == 'S' && p + 1 < eol && p[1] == '\t') {
            SRec r;
            const char *f = p + 2;
            const char *t = next_tab(f, eol);
            r.nid = f;
            r.nid_len = (int)(t - f);
            f = t < eol ? t + 1 : eol;
            t = next_tab(f, eol);
            r.seqlen = (long)(t - f);
            r.nc = 0;
            r.has_nc = false;
            r.ex = NULL;
            r.ex_len = -1;
            r.line = p;
            // tag fields
            f = t < eol ? t + 1 : eol;
            while (f < eol) {
                t = next_tab(f, eol);
                if (t - f >= 5 && f[2] == ':' && f[4] == ':') {
                    if (f[0] == 'N' && f[1] == 'C' && t - f > 5) {
                        r.nc = parse_long(f + 5, t);
                        r.has_nc = true;
                    }
                    else if (f[0] == 'E' && f[1] == 'X') {
                        r.ex = f + 5;
                        r.ex_len = (long)(t - (f + 5));
                    }
                }
                f = t < eol ? t + 1 : eol;
            }
            ss.push_back(r);
        } else if (c == 'L' && p + 1 < eol && p[1] == '\t') {
            LRec r;
            const char *f = p + 2;
            const char *t = next_tab(f, eol);
            r.a = f;
            r.a_len = (int)(t - f);
            f = t < eol ? t + 1 : eol;       // orient1
            t = next_tab(f, eol);
            f = t < eol ? t + 1 : eol;       // b
            t = next_tab(f, eol);
            r.b = f;
            r.b_len = (int)(t - f);
            f = t < eol ? t + 1 : eol;       // orient2
            t = next_tab(f, eol);
            f = t < eol ? t + 1 : eol;       // cigar
            t = next_tab(f, eol);
            r.rc = 0;
            r.has_rc = false;
            r.jn = NULL;
            r.jn_len = -1;
            r.novel = false;
            r.line = p;
            f = t < eol ? t + 1 : eol;
            while (f < eol) {
                t = next_tab(f, eol);
                if (t - f >= 5 && f[2] == ':' && f[4] == ':') {
                    if (f[0] == 'R' && f[1] == 'C' && t - f > 5) {
                        r.rc = parse_long(f + 5, t);
                        r.has_rc = true;
                    }
                    else if (f[0] == 'J' && f[1] == 'N') {
                        r.jn = f + 5;
                        r.jn_len = (long)(t - (f + 5));
                    } else if (f[0] == 'I' && f[1] == 'D')
                        r.novel = true;
                }
                f = t < eol ? t + 1 : eol;
            }
            ls.push_back(r);
        }
        p = nl ? nl + 1 : end;
    }
}

// ---------------------------------------------------------------------------
// Graph tables (phase 1, GIL released): the file's records as flat arrays.
// Segments and links are numbered in first-seen file order, the key order
// of the Python loader's dicts; a repeated id or pair keeps that position
// and takes the fields of its last line, as a dict assignment does. The
// adjacency lists are CSR over every L line in file order.
// ---------------------------------------------------------------------------

static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 30;
    x *= 0xbf58476d1ce4e5b9ull;
    x ^= x >> 27;
    x *= 0x94d049bb133111ebull;
    return x ^ (x >> 31);
}

static inline uint64_t hash_bytes(const char *p, size_t n) {
    uint64_t h = 0x9e3779b97f4a7c15ull ^ n;
    for (; n >= 8; p += 8, n -= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        h = mix64(h ^ w);
    }
    uint64_t w = 0;
    memcpy(&w, p, n);
    return mix64(h ^ w);
}

static inline uint64_t pair_key(int32_t a, int32_t b) {
    return ((uint64_t)(uint32_t)a << 32) | (uint32_t)b;
}

static inline uint64_t id_head(const char *p, size_t n) {  // an id's first 8 bytes
    uint64_t w = 0;
    memcpy(&w, p, n < 8 ? n : 8);
    return w;
}

static size_t table_size(size_t n) {
    size_t s = 16;
    while (s < 2 * n) s <<= 1;
    return s;
}

// Index slots hold what a probe compares, so a probe reads one slot: an id
// of at most 8 bytes (every numeric id under 10^8) is compared whole there.
struct IdSlot {
    uint64_t head;
    uint32_t len;
    uint32_t seg;  // segment + 1, 0 = empty
};

struct PairSlot {
    uint64_t pair;
    uint32_t link;  // link + 1, 0 = empty
    uint32_t pad;
};

struct Tables {
    std::vector<SRec> ss;               // S lines, file order
    std::vector<LRec> ls;               // L lines, file order
    std::vector<int32_t> seg_first;     // per segment: its first S line (id)
    std::vector<int32_t> seg_last;      // ... and its last (fields)
    std::vector<const char *> seg_line; // ... and where its first S line is
    std::vector<IdSlot> seg_slots;      // open addressing on the id
    std::vector<int32_t> end_a, end_b;  // per L line: its segments (-1 = unknown)
    std::vector<int32_t> link_first;    // per link: its first L line (pair)
    std::vector<int32_t> link_last;     // ... and its last (fields)
    std::vector<PairSlot> link_slots;   // open addressing on (a, b)
    std::vector<int64_t> out_off, in_off;  // per segment, into out_nb / in_nb
    std::vector<int32_t> out_nb, in_nb;
    int64_t bad = -1;  // first L line naming an unknown segment or one whose S line follows

    int32_t find_seg(const char *p, size_t n) const {
        if (seg_slots.empty()) return -1;
        size_t mask = seg_slots.size() - 1;
        uint64_t head = id_head(p, n);
        for (size_t i = hash_bytes(p, n) & mask;; i = (i + 1) & mask) {
            const IdSlot &s = seg_slots[i];
            if (!s.seg) return -1;
            if (s.head == head && s.len == n &&
                (n <= 8 || memcmp(ss[seg_first[s.seg - 1]].nid + 8, p + 8, n - 8) == 0))
                return (int32_t)(s.seg - 1);
        }
    }

    int32_t find_link(int32_t a, int32_t b) const {
        if (link_slots.empty() || a < 0 || b < 0) return -1;
        size_t mask = link_slots.size() - 1;
        uint64_t key = pair_key(a, b);
        for (size_t i = mix64(key) & mask;; i = (i + 1) & mask) {
            const PairSlot &s = link_slots[i];
            if (!s.link) return -1;
            if (s.pair == key) return (int32_t)(s.link - 1);
        }
    }

    bool late(int32_t seg, const LRec &r) const { return seg < 0 || seg_line[seg] > r.line; }
};

// fn(i) for i in [0, n) on n threads (the caller's is one of them)
template <class F>
static void run_chunks(unsigned n, F fn) {
    std::vector<std::thread> threads;
    unsigned i = 1;
    try {
        for (; i < n; ++i) threads.emplace_back(fn, i);
    } catch (const std::system_error &) {
        for (; i < n; ++i) fn(i);
    }
    fn(0);
    for (auto &t : threads) t.join();
}

static void scan_file(const char *data, size_t size, unsigned nt, Tables &t) {
    if (nt < 2 || size < (1u << 20)) {
        scan_records(data, size, t.ss, t.ls);
        return;
    }
    // split at line boundaries; records concatenate in chunk order,
    // preserving exact file order of S and of L records
    std::vector<size_t> bounds{0};
    for (unsigned i = 1; i < nt; ++i) {
        size_t guess = size * i / nt;
        const char *nl = (const char *)memchr(data + guess, '\n', size - guess);
        bounds.push_back(nl ? (size_t)(nl - data) + 1 : size);
    }
    bounds.push_back(size);
    std::vector<std::vector<SRec>> sss(nt);
    std::vector<std::vector<LRec>> lss(nt);
    run_chunks(nt, [&](unsigned i) {
        if (bounds[i] < bounds[i + 1])
            scan_records(data + bounds[i], bounds[i + 1] - bounds[i], sss[i], lss[i]);
    });
    size_t ns = 0, nl = 0;
    for (unsigned i = 0; i < nt; ++i) ns += sss[i].size(), nl += lss[i].size();
    t.ss.reserve(ns);
    t.ls.reserve(nl);
    for (unsigned i = 0; i < nt; ++i) {
        t.ss.insert(t.ss.end(), sss[i].begin(), sss[i].end());
        t.ls.insert(t.ls.end(), lss[i].begin(), lss[i].end());
    }
}

// insert(k, slot) for k in [0, n), in order, with the slot of the key
// AHEAD places on prefetched: the tables outgrow the caches, and a probe's
// miss, not its work, sets an insert's time.
template <class Slot, class Hash, class Insert>
static void insert_ahead(const std::vector<Slot> &slots, size_t n, Hash hash, Insert insert) {
    const size_t AHEAD = 16;
    size_t mask = slots.size() - 1, ring[AHEAD];
    for (size_t k = 0; k < n && k < AHEAD; ++k) {
        ring[k] = hash(k) & mask;
        __builtin_prefetch(&slots[ring[k]]);
    }
    for (size_t k = 0; k < n; ++k) {
        size_t i = ring[k % AHEAD];
        if (k + AHEAD < n) {
            ring[k % AHEAD] = hash(k + AHEAD) & mask;
            __builtin_prefetch(&slots[ring[k % AHEAD]]);
        }
        insert(k, i);
    }
}

static void index_segments(Tables &t) {
    size_t n = t.ss.size();
    t.seg_slots.assign(table_size(n), IdSlot{0, 0, 0});
    size_t mask = t.seg_slots.size() - 1;
    t.seg_first.reserve(n);
    t.seg_last.reserve(n);
    t.seg_line.reserve(n);
    auto hash = [&](size_t k) { return hash_bytes(t.ss[k].nid, (size_t)t.ss[k].nid_len); };
    insert_ahead(t.seg_slots, n, hash, [&](size_t k, size_t i) {
        const SRec &r = t.ss[k];
        size_t len = (size_t)r.nid_len;
        uint64_t head = id_head(r.nid, len);
        for (;; i = (i + 1) & mask) {
            IdSlot &s = t.seg_slots[i];
            if (!s.seg) {
                t.seg_first.push_back((int32_t)k);
                t.seg_last.push_back((int32_t)k);
                t.seg_line.push_back(r.line);
                s = IdSlot{head, (uint32_t)len, (uint32_t)t.seg_first.size()};
                return;
            }
            if (s.head == head && s.len == len &&
                (len <= 8 || memcmp(t.ss[t.seg_first[s.seg - 1]].nid + 8, r.nid + 8, len - 8) == 0)) {
                t.seg_last[s.seg - 1] = (int32_t)k;
                return;
            }
        }
    });
}

// Each L line's two segments, in nt threads. The single-pass Python loader
// raises KeyError on an L line naming a segment that is unknown or whose S
// line comes later; t.bad keeps the first such line for the same error.
static void resolve_ends(Tables &t, unsigned nt) {
    size_t n = t.ls.size();
    t.end_a.resize(n);
    t.end_b.resize(n);
    if (n < (1u << 16)) nt = 1;
    std::vector<int64_t> bad(nt, -1);
    run_chunks(nt, [&](unsigned c) {
        for (size_t k = n * c / nt, hi = n * (c + 1) / nt; k < hi; ++k) {
            const LRec &r = t.ls[k];
            int32_t a = t.find_seg(r.a, (size_t)r.a_len);
            int32_t b = t.find_seg(r.b, (size_t)r.b_len);
            t.end_a[k] = a;
            t.end_b[k] = b;
            if (bad[c] < 0 && (t.late(a, r) || t.late(b, r))) bad[c] = (int64_t)k;
        }
    });
    for (int64_t k : bad)
        if (k >= 0) {
            t.bad = k;
            break;
        }
}

static void index_links(Tables &t) {
    size_t n = t.ls.size(), ns = t.seg_first.size();
    t.link_slots.assign(table_size(n), PairSlot{0, 0, 0});
    size_t mask = t.link_slots.size() - 1;
    t.link_first.reserve(n);
    t.link_last.reserve(n);
    t.out_off.assign(ns + 1, 0);
    t.in_off.assign(ns + 1, 0);
    auto hash = [&](size_t k) { return mix64(pair_key(t.end_a[k], t.end_b[k])); };
    insert_ahead(t.link_slots, n, hash, [&](size_t k, size_t i) {
        int32_t a = t.end_a[k], b = t.end_b[k];
        ++t.out_off[a + 1];
        ++t.in_off[b + 1];
        uint64_t key = pair_key(a, b);
        for (;; i = (i + 1) & mask) {
            PairSlot &s = t.link_slots[i];
            if (!s.link) {
                t.link_first.push_back((int32_t)k);
                t.link_last.push_back((int32_t)k);
                s = PairSlot{key, (uint32_t)t.link_first.size(), 0};
                return;
            }
            if (s.pair == key) {
                t.link_last[s.link - 1] = (int32_t)k;
                return;
            }
        }
    });
    for (size_t u = 0; u < ns; ++u) {
        t.out_off[u + 1] += t.out_off[u];
        t.in_off[u + 1] += t.in_off[u];
    }
    t.out_nb.resize(n);
    t.in_nb.resize(n);
    std::vector<int64_t> oc(t.out_off.begin(), t.out_off.end() - 1);
    std::vector<int64_t> ic(t.in_off.begin(), t.in_off.end() - 1);
    for (size_t k = 0; k < n; ++k) {
        t.out_nb[oc[t.end_a[k]]++] = t.end_b[k];
        t.in_nb[ic[t.end_b[k]]++] = t.end_a[k];
    }
}

// ---------------------------------------------------------------------------
// Core: the tables, the mapped file and each segment id's str, made once on
// first use and shared by every record, key and adjacency list.
// ---------------------------------------------------------------------------

typedef struct {
    PyObject_HEAD
    Tables *t;
    PyObject *buf;   // BufObj, or NULL for an empty file
    PyObject **ids;  // per segment: its id str, or NULL
} CoreObj;

static void Core_dealloc(CoreObj *self) {
    if (self->ids && self->t) {
        for (size_t u = 0; u < self->t->seg_first.size(); ++u) Py_XDECREF(self->ids[u]);
        delete[] self->ids;
    }
    delete self->t;
    Py_XDECREF(self->buf);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyTypeObject CoreType = {
    PyVarObject_HEAD_INIT(NULL, 0)
};

static PyObject *core_id(CoreObj *c, int32_t u) {  // new reference
    PyObject *s = c->ids[u];
    if (!s) {
        const SRec &r = c->t->ss[c->t->seg_first[u]];
        s = PyUnicode_FromStringAndSize(r.nid, r.nid_len);
        if (!s) return NULL;
        c->ids[u] = s;
    }
    return Py_NewRef(s);
}

static PyObject *core_pair(CoreObj *c, size_t k) {  // (a, b) of L line k
    PyObject *a = core_id(c, c->t->end_a[k]);
    if (!a) return NULL;
    PyObject *b = core_id(c, c->t->end_b[k]);
    if (!b) {
        Py_DECREF(a);
        return NULL;
    }
    PyObject *pair = PyTuple_Pack(2, a, b);
    Py_DECREF(a);
    Py_DECREF(b);
    return pair;
}

static PyObject *id_list(CoreObj *c, const int32_t *nb, int64_t n) {
    PyObject *out = PyList_New((Py_ssize_t)n);
    if (!out) return NULL;
    for (int64_t i = 0; i < n; ++i) {
        PyObject *s = core_id(c, nb[i]);
        if (!s) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, (Py_ssize_t)i, s);
    }
    return out;
}

static PyObject *make_seg(CoreObj *c, int32_t u) {
    const Tables &t = *c->t;
    const SRec &r = t.ss[t.seg_last[u]];
    SegObj *s = (SegObj *)SegType.tp_alloc(&SegType, 0);
    if (!s) return NULL;
    s->length = r.seqlen;
    s->ex_len = -1;
    if (r.ex_len >= 0) {
        s->ex_ptr = r.ex;
        s->ex_len = r.ex_len;
        s->buf = Py_NewRef(c->buf);
    }
    s->nc = r.has_nc ? PyLong_FromLong(r.nc) : Py_NewRef(Py_None);
    s->outgoing = id_list(c, t.out_nb.data() + t.out_off[u], t.out_off[u + 1] - t.out_off[u]);
    s->incoming = id_list(c, t.in_nb.data() + t.in_off[u], t.in_off[u + 1] - t.in_off[u]);
    if (!s->nc || !s->outgoing || !s->incoming) {
        Py_DECREF(s);
        return NULL;
    }
    return (PyObject *)s;
}

static PyObject *make_link(CoreObj *c, int32_t u) {
    const LRec &r = c->t->ls[c->t->link_last[u]];
    LinkObj *li = (LinkObj *)LinkType.tp_alloc(&LinkType, 0);
    if (!li) return NULL;
    li->jn_len = -1;
    if (r.jn_len >= 0) {
        li->jn_ptr = r.jn;
        li->jn_len = r.jn_len;
        li->buf = Py_NewRef(c->buf);
    }
    li->novel = Py_NewRef(r.novel ? Py_True : Py_False);
    li->rc = r.has_rc ? PyLong_FromLong(r.rc) : Py_NewRef(Py_None);
    if (!li->rc) {
        Py_DECREF(li);
        return NULL;
    }
    return (PyObject *)li;
}

// ---------------------------------------------------------------------------
// Map: `seg` (id -> Seg) or `link` ((a, b) -> Link) over the tables. A
// record is built on its first lookup and kept, so a later mutation
// persists; `cache` holds every record built, assigned or added by its key,
// so a lookup of one is a dict lookup. Iteration is in file order, then the
// keys the file does not hold in insertion order, as the Python loader's
// dicts iterate.
// ---------------------------------------------------------------------------

typedef struct {
    PyObject_HEAD
    CoreObj *core;
    int links;           // 0: segments by id, 1: links by (a, b)
    Py_ssize_t in_file;  // records the file holds
    Py_ssize_t built;    // of those, records built from the tables
    PyObject **recs;     // per record of the file: built or assigned, or NULL
    PyObject *cache;     // dict key -> record
    PyObject *added;     // list of the keys the file does not hold
} MapObj;

static void Map_dealloc(MapObj *self) {
    if (self->recs) {
        for (Py_ssize_t i = 0; i < self->in_file; ++i) Py_XDECREF(self->recs[i]);
        delete[] self->recs;
    }
    Py_XDECREF(self->cache);
    Py_XDECREF(self->added);
    Py_XDECREF(self->core);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyTypeObject MapType = {
    PyVarObject_HEAD_INIT(NULL, 0)
};

static int32_t find_id(const Tables &t, PyObject *key) {
    if (!PyUnicode_Check(key)) return -1;
    Py_ssize_t n;
    const char *p = PyUnicode_AsUTF8AndSize(key, &n);
    if (!p) {  // not encodable, so no id of the file
        PyErr_Clear();
        return -1;
    }
    return t.find_seg(p, (size_t)n);
}

// the file record that `key` names, or -1
static Py_ssize_t map_find(MapObj *m, PyObject *key) {
    const Tables &t = *m->core->t;
    if (!m->links) return find_id(t, key);
    if (!PyTuple_Check(key) || PyTuple_GET_SIZE(key) != 2) return -1;
    return t.find_link(find_id(t, PyTuple_GET_ITEM(key, 0)), find_id(t, PyTuple_GET_ITEM(key, 1)));
}

static PyObject *map_key(MapObj *m, Py_ssize_t i) {  // key of file record i
    if (!m->links) return core_id(m->core, (int32_t)i);
    return core_pair(m->core, (size_t)m->core->t->link_first[i]);
}

// file record i, built and cached under `key` (its own when NULL) on first use
static PyObject *map_record(MapObj *m, Py_ssize_t i, PyObject *key) {
    if (m->recs[i]) return Py_NewRef(m->recs[i]);
    PyObject *rec = m->links ? make_link(m->core, (int32_t)i) : make_seg(m->core, (int32_t)i);
    if (!rec) return NULL;
    PyObject *k = key ? Py_NewRef(key) : map_key(m, i);
    if (!k || PyDict_SetItem(m->cache, k, rec) < 0) {
        Py_XDECREF(k);
        Py_DECREF(rec);
        return NULL;
    }
    Py_DECREF(k);
    m->recs[i] = Py_NewRef(rec);
    ++m->built;
    return rec;
}

static void set_key_error(PyObject *key) {
    PyObject *args = PyTuple_Pack(1, key);  // a tuple key stays one argument
    if (args) {
        PyErr_SetObject(PyExc_KeyError, args);
        Py_DECREF(args);
    }
}

// the record under `key`; NULL without an error set when there is none
static PyObject *map_lookup(MapObj *m, PyObject *key) {
    PyObject *v = PyDict_GetItemWithError(m->cache, key);
    if (v) return Py_NewRef(v);
    if (PyErr_Occurred()) return NULL;
    Py_ssize_t i = map_find(m, key);
    return i < 0 ? NULL : map_record(m, i, key);
}

static PyObject *Map_subscript(MapObj *m, PyObject *key) {
    PyObject *v = map_lookup(m, key);
    if (!v && !PyErr_Occurred()) set_key_error(key);
    return v;
}

static int Map_ass_subscript(MapObj *m, PyObject *key, PyObject *value) {
    if (!value) {
        PyErr_SetString(PyExc_TypeError, "graph records cannot be deleted");
        return -1;
    }
    Py_ssize_t i = map_find(m, key);
    int known = i >= 0 ? 1 : PyDict_Contains(m->cache, key);
    if (known < 0 || PyDict_SetItem(m->cache, key, value) < 0) return -1;
    if (i >= 0) {
        Py_XSETREF(m->recs[i], Py_NewRef(value));
    } else if (!known && PyList_Append(m->added, key) < 0) {
        PyDict_DelItem(m->cache, key);
        return -1;
    }
    return 0;
}

static Py_ssize_t Map_length(MapObj *m) { return m->in_file + PyList_GET_SIZE(m->added); }

static int Map_contains(MapObj *m, PyObject *key) {
    int has = PyDict_Contains(m->cache, key);
    if (has) return has;
    return map_find(m, key) >= 0;
}

static PyObject *Map_get(MapObj *m, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs < 1 || nargs > 2) {
        PyErr_Format(PyExc_TypeError, "get expected 1 or 2 arguments, got %zd", nargs);
        return NULL;
    }
    PyObject *v = map_lookup(m, args[0]);
    if (v || PyErr_Occurred()) return v;
    return Py_NewRef(nargs > 1 ? args[1] : Py_None);
}

// keys (0), records (1) or (key, record) pairs (2) in iteration order: the
// file's records, then the keys added; a record not built yet is built
static PyObject *map_list(MapObj *m, int what) {
    Py_ssize_t n = Map_length(m);
    PyObject *out = PyList_New(n);
    for (Py_ssize_t i = 0; out && i < n; ++i) {
        PyObject *key, *value = NULL;
        if (i < m->in_file) {
            key = map_key(m, i);
            if (key && what) value = map_record(m, i, key);
        } else {
            key = Py_NewRef(PyList_GET_ITEM(m->added, i - m->in_file));
            if (what) value = Py_XNewRef(PyDict_GetItemWithError(m->cache, key));
        }
        PyObject *item = what == 0 ? Py_XNewRef(key)
                         : what == 1 ? Py_XNewRef(value)
                         : key && value ? PyTuple_Pack(2, key, value) : NULL;
        Py_XDECREF(key);
        Py_XDECREF(value);
        if (!item) {
            if (!PyErr_Occurred()) PyErr_SetString(PyExc_RuntimeError, "graph record lost");
            Py_CLEAR(out);
            break;
        }
        PyList_SET_ITEM(out, i, item);
    }
    return out;
}

static PyObject *Map_iter(MapObj *m) {
    PyObject *keys = map_list(m, 0);
    if (!keys) return NULL;
    PyObject *it = PyObject_GetIter(keys);
    Py_DECREF(keys);
    return it;
}

static PyObject *Map_keys(MapObj *m, PyObject *) { return map_list(m, 0); }
static PyObject *Map_values(MapObj *m, PyObject *) { return map_list(m, 1); }
static PyObject *Map_items(MapObj *m, PyObject *) { return map_list(m, 2); }

static PyMethodDef Map_methods[] = {
    {"get", (PyCFunction)(void (*)(void))Map_get, METH_FASTCALL, "get(key, default=None)"},
    {"keys", (PyCFunction)Map_keys, METH_NOARGS, "the keys in order, as a list"},
    {"values", (PyCFunction)Map_values, METH_NOARGS, "the records in order, as a list"},
    {"items", (PyCFunction)Map_items, METH_NOARGS, "(key, record) in order, as a list"},
    {NULL, NULL, 0, NULL},
};

static PyMemberDef Map_members[] = {
    {"in_file", T_PYSSIZET, offsetof(MapObj, in_file), READONLY, "records the file holds"},
    {"built", T_PYSSIZET, offsetof(MapObj, built), READONLY,
     "records of the file built so far"},
    {NULL, 0, 0, 0, NULL},
};

static PyMappingMethods Map_as_mapping = {
    (lenfunc)Map_length, (binaryfunc)Map_subscript, (objobjargproc)Map_ass_subscript,
};

static PySequenceMethods Map_as_sequence = {};

static PyObject *new_map(CoreObj *core, int links, Py_ssize_t n) {
    MapObj *m = PyObject_New(MapObj, &MapType);
    if (!m) return NULL;
    m->core = (CoreObj *)Py_NewRef(core);
    m->links = links;
    m->in_file = n;
    m->built = 0;
    m->recs = new (std::nothrow) PyObject *[n > 0 ? n : 1]();
    m->cache = PyDict_New();
    m->added = PyList_New(0);
    if (!m->recs || !m->cache || !m->added) {
        Py_DECREF(m);
        return PyErr_NoMemory();
    }
    return (PyObject *)m;
}

// ---------------------------------------------------------------------------
// load(path) -> (seg, link, junctions, novel_junctions,
//                j_by_head, j_by_tail, nj_by_head, nj_by_tail)
// seg and link are Maps; the junction sets and the four endpoint indexes
// are real sets and dicts, built in L-line order from the JN- and ID-tagged
// lines alone, so their hash order is the Python loader's.
// ---------------------------------------------------------------------------

static int index_add(PyObject *index, PyObject *key, PyObject *pair) {
    PyObject *s = PyDict_GetItem(index, key);  // borrowed
    if (!s) {
        s = PySet_New(NULL);
        if (!s) return -1;
        if (PyDict_SetItem(index, key, s) < 0) {
            Py_DECREF(s);
            return -1;
        }
        Py_DECREF(s);  // dict holds it
        s = PyDict_GetItem(index, key);
    }
    return PySet_Add(s, pair);
}

static int add_junction(PyObject *set, PyObject *by_head, PyObject *by_tail, PyObject *pair) {
    if (PySet_Add(set, pair) < 0) return -1;
    if (index_add(by_head, PyTuple_GET_ITEM(pair, 0), pair) < 0) return -1;
    return index_add(by_tail, PyTuple_GET_ITEM(pair, 1), pair);
}

static PyObject *gfaload_load(PyObject *, PyObject *args) {
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path)) return NULL;

    int fd = open(path, O_RDONLY);
    if (fd < 0) return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    }
    size_t size = (size_t)st.st_size;
    const char *data = NULL;
    if (size > 0) {
        data = (const char *)mmap(NULL, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (data == MAP_FAILED) {
            close(fd);
            return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        }
        madvise((void *)data, size, MADV_SEQUENTIAL);
        madvise((void *)data, size, MADV_WILLNEED);
    }
    close(fd);

    CoreObj *core = PyObject_New(CoreObj, &CoreType);
    if (!core) {
        if (data) munmap((void *)data, size);
        return NULL;
    }
    core->t = NULL;
    core->ids = NULL;
    core->buf = NULL;
    if (data) {
        BufObj *buf = (BufObj *)BufType.tp_alloc(&BufType, 0);
        if (!buf) {
            munmap((void *)data, size);
            Py_DECREF(core);
            return NULL;
        }
        buf->data = data;  // Buf now owns the mapping
        buf->size = size;
        core->buf = (PyObject *)buf;
    }
    core->t = new (std::nothrow) Tables();
    if (!core->t) {
        Py_DECREF(core);
        return PyErr_NoMemory();
    }
    Tables &t = *core->t;
    bool oom = false;
    Py_BEGIN_ALLOW_THREADS
    try {
        unsigned nt = std::thread::hardware_concurrency();
        if (nt > 8) nt = 8;
        if (nt < 1) nt = 1;
        if (data) scan_file(data, size, nt, t);
        index_segments(t);
        resolve_ends(t, nt);
        if (t.bad < 0) index_links(t);
    } catch (const std::bad_alloc &) {
        oom = true;
    }
    Py_END_ALLOW_THREADS
    if (oom) {
        Py_DECREF(core);
        return PyErr_NoMemory();
    }
    if (t.bad >= 0) {
        // the Python loader's KeyError: the first of the line's two ids
        // that is unknown or defined later
        const LRec &r = t.ls[(size_t)t.bad];
        bool first = t.late(t.end_a[(size_t)t.bad], r);
        PyObject *id = first ? PyUnicode_FromStringAndSize(r.a, r.a_len)
                             : PyUnicode_FromStringAndSize(r.b, r.b_len);
        if (id) {
            set_key_error(id);
            Py_DECREF(id);
        }
        Py_DECREF(core);
        return NULL;
    }
    size_t nseg = t.seg_first.size();
    core->ids = new (std::nothrow) PyObject *[nseg > 0 ? nseg : 1]();
    if (!core->ids) {
        Py_DECREF(core);
        return PyErr_NoMemory();
    }

    PyObject *seg = new_map(core, 0, (Py_ssize_t)nseg);
    PyObject *link = new_map(core, 1, (Py_ssize_t)t.link_first.size());
    PyObject *junctions = PySet_New(NULL);
    PyObject *novel_junctions = PySet_New(NULL);
    PyObject *j_by_head = PyDict_New();
    PyObject *j_by_tail = PyDict_New();
    PyObject *nj_by_head = PyDict_New();
    PyObject *nj_by_tail = PyDict_New();
    PyObject *result = NULL;
    if (!seg || !link || !junctions || !novel_junctions || !j_by_head || !j_by_tail ||
        !nj_by_head || !nj_by_tail)
        goto done;

    // an empty JN:Z: is no junction, as in the Python loader (a DIVERGENCE
    // from the reference, events/caller.py::_from_gfa_py)
    for (size_t k = 0; k < t.ls.size(); ++k) {
        const LRec &r = t.ls[k];
        if (r.jn_len <= 0 && !r.novel) continue;
        PyObject *pair = core_pair(core, k);
        if (!pair) goto done;
        int bad = 0;
        if (r.jn_len > 0) bad = add_junction(junctions, j_by_head, j_by_tail, pair) < 0;
        if (!bad && r.novel) bad = add_junction(novel_junctions, nj_by_head, nj_by_tail, pair) < 0;
        Py_DECREF(pair);
        if (bad) goto done;
    }

    result = PyTuple_Pack(8, seg, link, junctions, novel_junctions, j_by_head, j_by_tail,
                          nj_by_head, nj_by_tail);

done:
    Py_XDECREF(seg);
    Py_XDECREF(link);
    Py_XDECREF(junctions);
    Py_XDECREF(novel_junctions);
    Py_XDECREF(j_by_head);
    Py_XDECREF(j_by_tail);
    Py_XDECREF(nj_by_head);
    Py_XDECREF(nj_by_tail);
    Py_DECREF(core);  // the maps hold it
    return result;
}

// ---------------------------------------------------------------------------
// Label tokenization (reference call.py:90-121 name algebra):
//   exon label  "T_H.e"     -> transcript key "T"
//   junction    "T_H.e1.e2" -> transcript key "T"
// rpartition semantics: missing '.' or '_' yields the empty key, exactly as
// the Python helpers (_exon_label_th / _split_ht) do.
// ---------------------------------------------------------------------------

static inline const char *rfind_ch(const char *s, Py_ssize_t n, char c) {
    for (const char *p = s + n - 1; p >= s; --p)
        if (*p == c) return p;
    return NULL;
}

static inline Py_ssize_t tkey_len(const char *s, Py_ssize_t n, int dots) {
    Py_ssize_t m = n;
    for (int i = 0; i < dots; ++i) {
        const char *dot = rfind_ch(s, m, '.');
        m = dot ? dot - s : 0;
    }
    const char *us = rfind_ch(s, m, '_');
    return us ? us - s : 0;
}

// gene_labels(exset, t2g) -> dict gene -> set(label)
// Per-node grouping of exon labels by gene; KeyError on unknown transcript
// (same as the Python t2g[...] lookup). Iterates the node's exon-label SET
// (not the raw tag string): the reference builds its gene-filtered exon
// sets by iterating that set (call.py:258-272), and downstream
// `next(iter(...))` picks are sensitive to the resulting insertion order —
// grouping must consume labels in the exact same order.
static PyObject *gfaload_gene_labels(PyObject *, PyObject *args) {
    PyObject *exset, *t2g;
    if (!PyArg_ParseTuple(args, "O!O!", &PySet_Type, &exset, &PyDict_Type, &t2g))
        return NULL;

    PyObject *out = PyDict_New();
    if (!out) return NULL;

    // tkey bytes -> (gene, its set in `out`); string_view keys are backed by
    // the label unicode objects' UTF-8 caches, which the exset keeps alive
    struct Entry {
        PyObject *gene;
        PyObject *set;  // borrowed from out
    };
    std::unordered_map<std::string_view, Entry> tcache;
    tcache.reserve(64);

    // direct set-table walk (_PySet_NextEntry follows the same order as a
    // Python-level iterator — required for downstream order parity)
    Py_ssize_t pos = 0;
    PyObject *label;
    Py_hash_t hash;
    while (_PySet_NextEntry(exset, &pos, &label, &hash)) {
        Py_ssize_t n;
        const char *p = PyUnicode_AsUTF8AndSize(label, &n);
        if (!p) goto fail;
        {
            Py_ssize_t kl = tkey_len(p, n, 1);
            std::string_view kv(p, (size_t)kl);
            auto it = tcache.find(kv);
            PyObject *s;
            if (it == tcache.end()) {
                PyObject *tkey = PyUnicode_FromStringAndSize(p, kl);
                if (!tkey) goto fail;
                PyObject *gene = PyDict_GetItem(t2g, tkey);  // borrowed
                if (!gene) {
                    PyErr_SetObject(PyExc_KeyError, tkey);
                    Py_DECREF(tkey);
                    goto fail;
                }
                Py_DECREF(tkey);
                s = PyDict_GetItem(out, gene);  // borrowed
                if (!s) {
                    s = PySet_New(NULL);
                    if (!s || PyDict_SetItem(out, gene, s) < 0) {
                        Py_XDECREF(s);
                        goto fail;
                    }
                    Py_DECREF(s);
                    s = PyDict_GetItem(out, gene);
                }
                tcache.emplace(kv, Entry{gene, s});
            } else {
                s = it->second.set;
            }
            if (PySet_Add(s, label) < 0) goto fail;
        }
    }
    return out;
fail:
    Py_DECREF(out);
    return NULL;
}

// jn_tkeys(jn_raw) -> set of transcript keys of a JN label list
static PyObject *gfaload_jn_tkeys(PyObject *, PyObject *args) {
    PyObject *jn_raw;
    if (!PyArg_ParseTuple(args, "U", &jn_raw)) return NULL;
    Py_ssize_t rawlen;
    const char *raw = PyUnicode_AsUTF8AndSize(jn_raw, &rawlen);
    if (!raw) return NULL;
    PyObject *out = PySet_New(NULL);
    if (!out) return NULL;
    const char *p = raw;
    const char *end = raw + rawlen;
    while (p <= end) {
        const char *comma = (const char *)memchr(p, ',', end - p);
        const char *e = comma ? comma : end;
        Py_ssize_t kl = tkey_len(p, e - p, 2);
        PyObject *tkey = PyUnicode_FromStringAndSize(p, kl);
        if (!tkey || PySet_Add(out, tkey) < 0) {
            Py_XDECREF(tkey);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(tkey);
        if (!comma) break;
        p = comma + 1;
    }
    return out;
}

// split_set(raw) -> set of the comma-separated items (exset semantics)
static PyObject *gfaload_split_set(PyObject *, PyObject *args) {
    PyObject *rawo;
    if (!PyArg_ParseTuple(args, "U", &rawo)) return NULL;
    Py_ssize_t rawlen;
    const char *raw = PyUnicode_AsUTF8AndSize(rawo, &rawlen);
    if (!raw) return NULL;
    PyObject *out = PySet_New(NULL);
    if (!out) return NULL;
    const char *p = raw;
    const char *end = raw + rawlen;
    while (p <= end) {
        const char *comma = (const char *)memchr(p, ',', end - p);
        const char *e = comma ? comma : end;
        PyObject *item = PyUnicode_FromStringAndSize(p, e - p);
        if (!item || PySet_Add(out, item) < 0) {
            Py_XDECREF(item);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(item);
        if (!comma) break;
        p = comma + 1;
    }
    return out;
}

// ---------------------------------------------------------------------------
// load_paths: the mapper's alignment-target paths, natively
// (behavioral contract: mapping/mapper.py::load_alignment_paths — S seq
// dict + P-line assembly, skipping haplotype transcript copies "_H<k>$")
// ---------------------------------------------------------------------------

static bool is_hap_copy(const char *name, Py_ssize_t n) {
    // suffix match for _H\d+$ (at least one digit)
    const char *e = name + n;
    const char *p = e;
    while (p > name && p[-1] >= '0' && p[-1] <= '9') --p;
    if (p == e) return false;          // no digits at the end
    if (p - name < 2) return false;    // room for "_H"
    return p[-1] == 'H' && p[-2] == '_';
}

static PyObject *gfaload_load_paths(PyObject *, PyObject *args) {
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path)) return NULL;

    int fd = open(path, O_RDONLY);
    if (fd < 0) return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    }
    size_t size = (size_t)st.st_size;
    const char *data = NULL;
    if (size > 0) {
        data = (const char *)mmap(NULL, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (data == MAP_FAILED) {
            close(fd);
            return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        }
        madvise((void *)data, size, MADV_SEQUENTIAL);
        madvise((void *)data, size, MADV_WILLNEED);
    }
    close(fd);

    // pass 1 (GIL released): S-line id -> seq views, P-line views.
    // Byte offsets are kept for both so pass 2 can match the Python
    // loop's ordering semantics (a P line before its S line is a
    // KeyError there) instead of silently accepting it.
    struct PView {
        const char *name;
        Py_ssize_t name_len;
        const char *steps;
        Py_ssize_t steps_len;
        const char *line;  // ordering vs S lines
    };
    struct SView {
        std::string_view sv;
        const char *line;
    };
    std::unordered_map<std::string_view, SView> seqs;
    std::vector<PView> pviews;
    Py_BEGIN_ALLOW_THREADS
    const char *p = data;
    const char *end = data + size;
    while (p && p < end) {
        const char *nl = (const char *)memchr(p, '\n', end - p);
        const char *eol = nl ? nl : end;
        if (*p == 'S' && p + 1 < eol && p[1] == '\t') {
            const char *f = p + 2;
            const char *t = next_tab(f, eol);
            std::string_view id(f, t - f);
            const char *ls = p;
            f = t < eol ? t + 1 : eol;
            t = next_tab(f, eol);
            seqs[id] = SView{std::string_view(f, t - f), ls};
        } else if (*p == 'P' && p + 1 < eol && p[1] == '\t') {
            const char *f = p + 2;
            const char *t = next_tab(f, eol);
            PView v;
            v.name = f;
            v.name_len = t - f;
            f = t < eol ? t + 1 : eol;
            t = next_tab(f, eol);
            v.steps = f;
            v.steps_len = t - f;
            v.line = p;
            if (!is_hap_copy(v.name, v.name_len)) pviews.push_back(v);
        }
        p = nl ? nl + 1 : end;
    }
    Py_END_ALLOW_THREADS

    // pass 2: build (name, nodes, offsets, seq) tuples; node-id strings
    // are shared through a cache (paths revisit the same nodes heavily)
    PyObject *out = PyList_New((Py_ssize_t)pviews.size());
    std::unordered_map<std::string_view, PyObject *> node_cache;
    bool fail = out == NULL;
    for (size_t pi = 0; !fail && pi < pviews.size(); ++pi) {
        const PView &v = pviews[pi];
        // split steps, strip the trailing orientation char of each step
        std::vector<std::string_view> nodes;
        const char *sp = v.steps;
        const char *se = v.steps + v.steps_len;
        while (sp < se) {
            const char *c = (const char *)memchr(sp, ',', se - sp);
            const char *fe = c ? c : se;
            if (fe > sp) nodes.emplace_back(sp, (size_t)(fe - sp - 1));
            sp = c ? c + 1 : se;
        }
        Py_ssize_t total = 0;
        for (auto &nd : nodes) {
            auto it = seqs.find(nd);
            if (it == seqs.end() || it->second.line > v.line) {
                // unknown segment, or the S line follows the P line: the
                // single-pass Python loop raises KeyError here — raise so
                // the caller falls back to it (identical semantics)
                PyErr_Format(PyExc_KeyError, "P line references unknown segment");
                fail = true;
                break;
            }
            total += (Py_ssize_t)it->second.sv.size();
        }
        if (fail) break;
        PyObject *name = PyUnicode_FromStringAndSize(v.name, v.name_len);
        PyObject *nlist = PyList_New((Py_ssize_t)nodes.size());
        PyObject *olist = PyList_New((Py_ssize_t)nodes.size());
        PyObject *seq = PyUnicode_New(total, 127);  // GFA seqs are ASCII
        if (!name || !nlist || !olist || !seq) {
            Py_XDECREF(name); Py_XDECREF(nlist); Py_XDECREF(olist); Py_XDECREF(seq);
            fail = true;
            break;
        }
        char *w = (char *)PyUnicode_DATA(seq);
        Py_ssize_t off = 0;
        for (size_t i = 0; i < nodes.size() && !fail; ++i) {
            auto &nd = nodes[i];
            PyObject *ns;
            auto cit = node_cache.find(nd);
            if (cit != node_cache.end()) {
                ns = cit->second;
                Py_INCREF(ns);
            } else {
                ns = PyUnicode_FromStringAndSize(nd.data(), (Py_ssize_t)nd.size());
                if (!ns) { fail = true; break; }
                Py_INCREF(ns);
                node_cache.emplace(nd, ns);  // cache holds one ref
            }
            PyList_SET_ITEM(nlist, (Py_ssize_t)i, ns);
            PyObject *ov = PyLong_FromSsize_t(off);
            if (!ov) { fail = true; break; }
            PyList_SET_ITEM(olist, (Py_ssize_t)i, ov);
            const std::string_view &sv = seqs[nd].sv;
            // validate before handing bytes to a PyUnicode_New(.., 127)
            // buffer: any byte >0x7F would make an invalid ASCII str
            // (interpreter UB); raise instead and let the caller fall
            // back to the Python loop (defined text decoding)
            for (size_t b = 0; b < sv.size(); ++b) {
                if ((unsigned char)sv[b] > 0x7F) {
                    PyErr_Format(PyExc_ValueError,
                                 "non-ASCII byte in segment sequence");
                    fail = true;
                    break;
                }
            }
            if (fail) break;
            memcpy(w + off, sv.data(), sv.size());
            off += (Py_ssize_t)sv.size();
        }
        if (fail) {
            Py_DECREF(name); Py_DECREF(nlist); Py_DECREF(olist); Py_DECREF(seq);
            break;
        }
        PyObject *tup = PyTuple_Pack(4, name, nlist, olist, seq);
        Py_DECREF(name); Py_DECREF(nlist); Py_DECREF(olist); Py_DECREF(seq);
        if (!tup) { fail = true; break; }
        PyList_SET_ITEM(out, (Py_ssize_t)pi, tup);
    }
    for (auto &kv : node_cache) Py_DECREF(kv.second);
    if (data) munmap((void *)data, size);
    if (fail) {
        Py_XDECREF(out);
        return NULL;
    }
    return out;
}

static PyMethodDef gfaload_methods[] = {
    {"load", gfaload_load, METH_VARARGS,
     "load(path) -> (seg, link, junctions, novel_junctions, j_by_head, "
     "j_by_tail, nj_by_head, nj_by_tail); seg and link build records on demand"},
    {"gene_labels", gfaload_gene_labels, METH_VARARGS,
     "gene_labels(ex_raw, t2g) -> {gene: set(labels)}"},
    {"jn_tkeys", gfaload_jn_tkeys, METH_VARARGS,
     "jn_tkeys(jn_raw) -> set of transcript keys"},
    {"split_set", gfaload_split_set, METH_VARARGS,
     "split_set(raw) -> set of comma-separated items"},
    {"load_paths", gfaload_load_paths, METH_VARARGS,
     "load_paths(path) -> [(name, nodes, offsets, seq)] for non-haplotype "
     "paths (mapper alignment targets)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef gfaload_module = {
    PyModuleDef_HEAD_INIT, "gfaload_ext",
    "Native GFA -> SplicingGraph loader", -1, gfaload_methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit_gfaload_ext(void) {
    BufType.tp_name = "gfaload_ext.Buf";
    BufType.tp_basicsize = sizeof(BufObj);
    BufType.tp_flags = Py_TPFLAGS_DEFAULT;
    BufType.tp_dealloc = (destructor)Buf_dealloc;

    SegType.tp_name = "gfaload_ext.Seg";
    SegType.tp_basicsize = sizeof(SegObj);
    SegType.tp_flags = Py_TPFLAGS_DEFAULT;
    SegType.tp_new = Seg_new;
    SegType.tp_init = (initproc)Seg_init;
    SegType.tp_dealloc = (destructor)Seg_dealloc;
    SegType.tp_members = Seg_members;
    SegType.tp_getset = Seg_getset;

    LinkType.tp_name = "gfaload_ext.Link";
    LinkType.tp_basicsize = sizeof(LinkObj);
    LinkType.tp_flags = Py_TPFLAGS_DEFAULT;
    LinkType.tp_new = Link_new;
    LinkType.tp_init = (initproc)Link_init;
    LinkType.tp_dealloc = (destructor)Link_dealloc;
    LinkType.tp_members = Link_members;
    LinkType.tp_getset = Link_getset;

    CoreType.tp_name = "gfaload_ext.Core";
    CoreType.tp_basicsize = sizeof(CoreObj);
    CoreType.tp_flags = Py_TPFLAGS_DEFAULT;
    CoreType.tp_dealloc = (destructor)Core_dealloc;

    MapType.tp_name = "gfaload_ext.Map";
    MapType.tp_basicsize = sizeof(MapObj);
    MapType.tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_MAPPING;
    MapType.tp_dealloc = (destructor)Map_dealloc;
    MapType.tp_as_mapping = &Map_as_mapping;
    Map_as_sequence.sq_contains = (objobjproc)Map_contains;
    MapType.tp_as_sequence = &Map_as_sequence;
    MapType.tp_iter = (getiterfunc)Map_iter;
    MapType.tp_methods = Map_methods;
    MapType.tp_members = Map_members;
    MapType.tp_doc = "A GFA's segments or links by key, each record built on its first lookup";

    if (PyType_Ready(&BufType) < 0 || PyType_Ready(&SegType) < 0 ||
        PyType_Ready(&LinkType) < 0 || PyType_Ready(&CoreType) < 0 ||
        PyType_Ready(&MapType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&gfaload_module);
    if (!m) return NULL;
    Py_INCREF(&SegType);
    PyModule_AddObject(m, "Seg", (PyObject *)&SegType);
    Py_INCREF(&LinkType);
    PyModule_AddObject(m, "Link", (PyObject *)&LinkType);
    return m;
}

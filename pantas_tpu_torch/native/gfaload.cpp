// Native GFA -> SplicingGraph loader (CPython extension).
//
// Parses an (augmented) annotated GFA and builds the exact structures the
// pure-Python SplicingGraph.from_gfa builds (behavioral contract:
// the reference caller, scripts/call.py:132-181): a seg dict, a link dict keyed
// by (a, b) string tuples, the annotated/novel junction sets, and the four
// endpoint indexes. Records are indexed with the GIL released (mmap +
// memchr scan), then Python objects are built in one C pass. Seg/Link are
// C types with the same attribute protocol as the Python SegInfo/LinkInfo
// classes, so every caller-side consumer works unchanged.
//
// Set/dict iteration-order parity: contents and insertion order match the
// Python parser exactly, and string hashing is the host interpreter's
// (PYTHONHASHSEED-respecting) siphash, so downstream hash-order-dependent
// row content (reference call.py:240,531 semantics) is identical to the
// pure-Python loader's within the same process seed.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <string_view>
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
// load(path) -> (seg, link, junctions, novel_junctions,
//                j_by_head, j_by_tail, nj_by_head, nj_by_tail)
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

    std::vector<SRec> ss;
    std::vector<LRec> ls;
    Py_BEGIN_ALLOW_THREADS
    if (data) {
        unsigned nt = std::thread::hardware_concurrency();
        if (nt > 8) nt = 8;
        if (nt < 2 || size < (1u << 20)) {
            scan_records(data, size, ss, ls);
        } else {
            // split at line boundaries; records concatenate in chunk order,
            // preserving exact file order of S and of L records
            std::vector<size_t> bounds{0};
            for (unsigned i = 1; i < nt; ++i) {
                size_t guess = size * i / nt;
                const char *nl =
                    (const char *)memchr(data + guess, '\n', size - guess);
                bounds.push_back(nl ? (size_t)(nl - data) + 1 : size);
            }
            bounds.push_back(size);
            std::vector<std::vector<SRec>> sss(nt);
            std::vector<std::vector<LRec>> lss(nt);
            std::vector<std::thread> threads;
            for (unsigned i = 0; i < nt; ++i) {
                size_t lo = bounds[i], hi = bounds[i + 1];
                if (lo >= hi) continue;
                threads.emplace_back([&, i, lo, hi] {
                    scan_records(data + lo, hi - lo, sss[i], lss[i]);
                });
            }
            for (auto &t : threads) t.join();
            for (unsigned i = 0; i < nt; ++i) {
                ss.insert(ss.end(), sss[i].begin(), sss[i].end());
                ls.insert(ls.end(), lss[i].begin(), lss[i].end());
            }
        }
    }
    Py_END_ALLOW_THREADS

    BufObj *buf = NULL;
    if (data) {
        buf = (BufObj *)BufType.tp_alloc(&BufType, 0);
        if (!buf) {
            munmap((void *)data, size);
            return NULL;
        }
        buf->data = data;  // Buf now owns the mapping
        buf->size = size;
    }

    PyObject *seg = PyDict_New();
    PyObject *link = PyDict_New();
    PyObject *junctions = PySet_New(NULL);
    PyObject *novel_junctions = PySet_New(NULL);
    PyObject *j_by_head = PyDict_New();
    PyObject *j_by_tail = PyDict_New();
    PyObject *nj_by_head = PyDict_New();
    PyObject *nj_by_tail = PyDict_New();
    PyObject *result = NULL;
    // S-line file positions: the single-pass Python loader raises
    // KeyError on an L line that precedes one of its S lines, so the
    // two-pass native loader must reject the same ordering (same
    // convention as load_paths below). Declared before any goto (jumps
    // may not cross a non-trivial initialization).
    std::unordered_map<std::string_view, const char *> s_pos;
    if (!seg || !link || !junctions || !novel_junctions || !j_by_head ||
        !j_by_tail || !nj_by_head || !nj_by_tail)
        goto done;

    for (const SRec &r : ss)
        s_pos.emplace(std::string_view(r.nid, (size_t)r.nid_len), r.line);
    for (const SRec &r : ss) {
        PyObject *key = PyUnicode_FromStringAndSize(r.nid, r.nid_len);
        if (!key) goto done;
        SegObj *s = (SegObj *)Seg_new(&SegType, NULL, NULL);
        if (!s) {
            Py_DECREF(key);
            goto done;
        }
        s->length = r.seqlen;
        if (r.has_nc) {
            PyObject *v = PyLong_FromLong(r.nc);
            if (!v) {
                Py_DECREF(key);
                Py_DECREF(s);
                goto done;
            }
            Py_SETREF(s->nc, v);
        }
        if (r.ex_len >= 0) {
            s->ex_ptr = r.ex;
            s->ex_len = r.ex_len;
            Py_INCREF(buf);
            s->buf = (PyObject *)buf;
        }
        int rcde = PyDict_SetItem(seg, key, (PyObject *)s);
        Py_DECREF(key);
        Py_DECREF(s);
        if (rcde < 0) goto done;
    }

    for (const LRec &r : ls) {
        PyObject *a = PyUnicode_FromStringAndSize(r.a, r.a_len);
        PyObject *b = r.b ? PyUnicode_FromStringAndSize(r.b, r.b_len) : NULL;
        if (!a || !b) {
            Py_XDECREF(a);
            Py_XDECREF(b);
            goto done;
        }
        LinkObj *li = (LinkObj *)Link_new(&LinkType, NULL, NULL);
        if (!li) {
            Py_DECREF(a);
            Py_DECREF(b);
            goto done;
        }
        if (r.has_rc) {
            PyObject *v = PyLong_FromLong(r.rc);
            if (!v) goto link_fail;
            Py_SETREF(li->rc, v);
        }
        if (r.jn_len >= 0) {
            li->jn_ptr = r.jn;
            li->jn_len = r.jn_len;
            Py_INCREF(buf);
            li->buf = (PyObject *)buf;
        }
        if (r.novel) {
            Py_INCREF(Py_True);
            Py_SETREF(li->novel, Py_True);
        }
        {
            PyObject *pair = PyTuple_Pack(2, a, b);
            if (!pair) goto link_fail;
            if (PyDict_SetItem(link, pair, (PyObject *)li) < 0) {
                Py_DECREF(pair);
                goto link_fail;
            }
            SegObj *sa = (SegObj *)PyDict_GetItem(seg, a);  // borrowed
            SegObj *sb = (SegObj *)PyDict_GetItem(seg, b);
            auto ita = s_pos.find(std::string_view(r.a, (size_t)r.a_len));
            auto itb = s_pos.find(std::string_view(r.b, (size_t)r.b_len));
            if (!sa || !sb || ita == s_pos.end() || itb == s_pos.end() ||
                ita->second > r.line || itb->second > r.line) {
                PyErr_Format(PyExc_KeyError,
                             "L line references unknown segment (%U or %U)", a, b);
                Py_DECREF(pair);
                goto link_fail;
            }
            if (PyList_Append(sa->outgoing, b) < 0 ||
                PyList_Append(sb->incoming, a) < 0) {
                Py_DECREF(pair);
                goto link_fail;
            }
            int bad = 0;
            if (r.jn_len > 0) {
                bad |= PySet_Add(junctions, pair) < 0;
                bad |= index_add(j_by_head, a, pair) < 0;
                bad |= index_add(j_by_tail, b, pair) < 0;
            }
            if (r.novel) {
                bad |= PySet_Add(novel_junctions, pair) < 0;
                bad |= index_add(nj_by_head, a, pair) < 0;
                bad |= index_add(nj_by_tail, b, pair) < 0;
            }
            Py_DECREF(pair);
            if (bad) goto link_fail;
        }
        Py_DECREF(a);
        Py_DECREF(b);
        Py_DECREF(li);
        continue;
    link_fail:
        Py_DECREF(a);
        Py_DECREF(b);
        Py_DECREF(li);
        goto done;
    }

    result = PyTuple_Pack(8, seg, link, junctions, novel_junctions, j_by_head,
                          j_by_tail, nj_by_head, nj_by_tail);

done:
    Py_XDECREF(seg);
    Py_XDECREF(link);
    Py_XDECREF(junctions);
    Py_XDECREF(novel_junctions);
    Py_XDECREF(j_by_head);
    Py_XDECREF(j_by_tail);
    Py_XDECREF(nj_by_head);
    Py_XDECREF(nj_by_tail);
    Py_XDECREF(buf);  // segs/links that captured slices keep it alive
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
     "j_by_tail, nj_by_head, nj_by_tail)"},
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

    if (PyType_Ready(&BufType) < 0 || PyType_Ready(&SegType) < 0 ||
        PyType_Ready(&LinkType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&gfaload_module);
    if (!m) return NULL;
    Py_INCREF(&SegType);
    PyModule_AddObject(m, "Seg", (PyObject *)&SegType);
    Py_INCREF(&LinkType);
    PyModule_AddObject(m, "Link", (PyObject *)&LinkType);
    return m;
}

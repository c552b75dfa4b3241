/* C-speed columnar history parser for the Elle list-append checker: the
 * port's copy of jepsen_tpu/native/columnar_ext.c:1-527 (the vec helpers,
 * as_i64, ctx, intern_kid, flatten_txn and parse), with a module table of
 * parse alone.
 *
 * One tight C pass over the PyObject history does the event pairing,
 * micro-op flattening, key interning, spine selection and prefix
 * verification that jepsen_tpu_torch/elle/columnar.py's numpy front
 * (_build_py) does, bit for bit; any input outside the fast regime returns
 * None and the caller takes the numpy front.
 *
 * Built at first use by jepsen_tpu_torch/native/columnar_c.py (g++, plain
 * CPython C API) and loaded as the extension module _columnar_c_torch: the
 * name differs from the reference's _columnar_c so that both load in one
 * process.
 */
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_KIDS (1 << 20)
#define MAX_MOPS (1 << 12)
#define MAX_VAL (4294967296LL) /* 1 << 32 */

typedef struct {
    int64_t *d;
    Py_ssize_t n, cap;
} vec;

static int vpush(vec *v, int64_t x) {
    if (v->n == v->cap) {
        Py_ssize_t nc = v->cap ? v->cap * 2 : 1024;
        int64_t *nd = (int64_t *)realloc(v->d, (size_t)nc * 8);
        if (!nd) return -1;
        v->d = nd;
        v->cap = nc;
    }
    v->d[v->n++] = x;
    return 0;
}

static void vfree(vec *v) {
    free(v->d);
    v->d = NULL;
    v->n = v->cap = 0;
}

static PyObject *vbytes(vec *v) {
    return PyByteArray_FromStringAndSize((char *)v->d, v->n * 8);
}

/* exact int -> int64 with overflow detection; returns -1 on overflow or
 * non-exact-int (bail), 0 ok */
static int as_i64(PyObject *o, int64_t *out) {
    if (!PyLong_CheckExact(o)) return -1;
    int ovf = 0;
    long long x = PyLong_AsLongLongAndOverflow(o, &ovf);
    if (ovf || (x == -1 && PyErr_Occurred())) {
        PyErr_Clear();
        return -1;
    }
    *out = (int64_t)x;
    return 0;
}

/* outcome codes for the parse */
#define OUT_OK 0
#define OUT_BAIL 1 /* regime miss: caller falls back to Python */
#define OUT_ERR 2  /* Python exception set */

typedef struct {
    vec ok_pos, info_pos, fail_pos;
    vec a_txn, a_kid, a_val, a_mi;
    vec r_txn, r_kid, r_mi, r_len, r_last;
    vec f_kid, f_val;
    vec s_concat, s_kid;
    int64_t *inv_pos;  /* [nh] */
    int64_t *best_len; /* [nk] spine */
    int64_t *best_row;
    int64_t *soff, *slen;
    PyObject *payloads, *raw_key, *kid_of, *state, *txns, *scrutiny;
    Py_ssize_t nk;
} ctx;

static void ctx_free(ctx *c) {
    vfree(&c->ok_pos); vfree(&c->info_pos); vfree(&c->fail_pos);
    vfree(&c->a_txn); vfree(&c->a_kid); vfree(&c->a_val); vfree(&c->a_mi);
    vfree(&c->r_txn); vfree(&c->r_kid); vfree(&c->r_mi); vfree(&c->r_len);
    vfree(&c->r_last);
    vfree(&c->f_kid); vfree(&c->f_val);
    vfree(&c->s_concat); vfree(&c->s_kid);
    free(c->inv_pos); free(c->best_len); free(c->best_row);
    free(c->soff); free(c->slen);
    Py_CLEAR(c->payloads); Py_CLEAR(c->raw_key); Py_CLEAR(c->kid_of);
    Py_CLEAR(c->state); Py_CLEAR(c->txns); Py_CLEAR(c->scrutiny);
}

/* interns key (an exact int object) into kid_of/raw_key; returns kid or
 * -1 (bail: too many keys) or -2 (error) */
static int64_t intern_kid(ctx *c, PyObject *key) {
    PyObject *got = PyDict_GetItemWithError(c->kid_of, key);
    if (got) return PyLong_AsLongLong(got);
    if (PyErr_Occurred()) return -2;
    if (c->nk >= MAX_KIDS) return -1;
    PyObject *idx = PyLong_FromSsize_t(c->nk);
    if (!idx) return -2;
    if (PyDict_SetItem(c->kid_of, key, idx) < 0) {
        Py_DECREF(idx);
        return -2;
    }
    Py_DECREF(idx);
    if (PyList_Append(c->raw_key, key) < 0) return -2;
    return (int64_t)c->nk++;
}

/* flatten one committed/info txn's micro-ops (pass B semantics).
 * ni = node index. Returns OUT_*. */
static int flatten_txn(ctx *c, PyObject *op, Py_ssize_t ni) {
    PyObject *value = PyDict_GetItemString(op, "value");
    if (!value) return OUT_OK;
    int truth = PyObject_IsTrue(value);
    if (truth < 0) return OUT_ERR;
    if (!truth) return OUT_OK; /* `op.get("value") or ()` */
    PyObject **items;
    Py_ssize_t nm;
    if (PyList_CheckExact(value)) {
        items = ((PyListObject *)value)->ob_item;
        nm = PyList_GET_SIZE(value);
    } else if (PyTuple_CheckExact(value)) {
        items = ((PyTupleObject *)value)->ob_item;
        nm = PyTuple_GET_SIZE(value);
    } else {
        return OUT_BAIL; /* exotic container: general loop handles it */
    }
    if (nm > MAX_MOPS) return OUT_BAIL;
    for (Py_ssize_t mi = 0; mi < nm; mi++) {
        PyObject *m = items[mi];
        PyObject **mit;
        Py_ssize_t ml;
        if (PyList_CheckExact(m)) {
            mit = ((PyListObject *)m)->ob_item;
            ml = PyList_GET_SIZE(m);
        } else if (PyTuple_CheckExact(m)) {
            mit = ((PyTupleObject *)m)->ob_item;
            ml = PyTuple_GET_SIZE(m);
        } else {
            return OUT_BAIL;
        }
        if (ml < 3) return OUT_BAIL; /* fast path needs [f, k, v] */
        PyObject *f = mit[0];
        if (!PyUnicode_CheckExact(f)) return OUT_BAIL;
        if (PyUnicode_CompareWithASCIIString(f, "append") == 0) {
            int64_t kid, val;
            if (!PyLong_CheckExact(mit[1])) return OUT_BAIL;
            kid = intern_kid(c, mit[1]);
            if (kid == -1) return OUT_BAIL;
            if (kid == -2) return OUT_ERR;
            if (as_i64(mit[2], &val) < 0) return OUT_BAIL;
            if (val < 0 || val >= MAX_VAL) return OUT_BAIL;
            if (vpush(&c->a_txn, ni) || vpush(&c->a_kid, kid) ||
                vpush(&c->a_val, val) || vpush(&c->a_mi, mi))
                return OUT_ERR;
        } else if (PyUnicode_CompareWithASCIIString(f, "r") == 0) {
            PyObject *third = mit[2];
            if (third == Py_None) continue; /* unfulfilled read */
            int64_t kid;
            if (!PyLong_CheckExact(mit[1])) return OUT_BAIL;
            kid = intern_kid(c, mit[1]);
            if (kid == -1) return OUT_BAIL;
            if (kid == -2) return OUT_ERR;
            PyObject *payload;
            if (PyList_CheckExact(third)) {
                payload = third;
                Py_INCREF(payload);
            } else {
                payload = PySequence_List(third);
                if (!payload) return OUT_ERR;
            }
            Py_ssize_t plen = PyList_GET_SIZE(payload);
            int64_t last = -1;
            if (plen > 0 &&
                as_i64(PyList_GET_ITEM(payload, plen - 1), &last) < 0) {
                Py_DECREF(payload);
                return OUT_BAIL; /* non-int tail: Python scrutiny path */
            }
            if (PyList_Append(c->payloads, payload) < 0) {
                Py_DECREF(payload);
                return OUT_ERR;
            }
            Py_DECREF(payload);
            if (vpush(&c->r_txn, ni) || vpush(&c->r_kid, kid) ||
                vpush(&c->r_mi, mi) || vpush(&c->r_len, plen) ||
                vpush(&c->r_last, last))
                return OUT_ERR;
        } /* other mop types: ignored, keys not interned */
    }
    return OUT_OK;
}

static PyObject *parse(PyObject *self, PyObject *args) {
    PyObject *history;
    if (!PyArg_ParseTuple(args, "O", &history)) return NULL;
    if (!PyList_CheckExact(history)) Py_RETURN_NONE;
    Py_ssize_t nh = PyList_GET_SIZE(history);

    ctx c;
    memset(&c, 0, sizeof(c));
    int out = OUT_BAIL;
    Py_ssize_t n_ok = 0, n = 0;
    PyObject *result = NULL;
    vec node_proc_v;
    memset(&node_proc_v, 0, sizeof(node_proc_v));

    c.payloads = PyList_New(0);
    c.raw_key = PyList_New(0);
    c.kid_of = PyDict_New();
    c.state = PyDict_New();
    c.txns = PyList_New(0);
    c.scrutiny = PyList_New(0);
    if (!c.payloads || !c.raw_key || !c.kid_of || !c.state || !c.txns ||
        !c.scrutiny) {
        out = OUT_ERR;
        goto done;
    }
    c.inv_pos = (int64_t *)malloc((size_t)(nh > 0 ? nh : 1) * 8);
    if (!c.inv_pos) {
        PyErr_NoMemory();
        out = OUT_ERR;
        goto done;
    }

    /* ---- pass A: event scan + invocation pairing -------------------- */
    for (Py_ssize_t i = 0; i < nh; i++) {
        c.inv_pos[i] = -1;
        PyObject *op = PyList_GET_ITEM(history, i);
        if (!PyDict_Check(op)) { out = OUT_BAIL; goto done; }
        PyObject *type = PyDict_GetItemString(op, "type");
        int ev = -1, is_ok = 0, is_info = 0, is_fail = 0;
        if (type && PyUnicode_CheckExact(type)) {
            if (PyUnicode_CompareWithASCIIString(type, "invoke") == 0)
                ev = 0;
            else if (PyUnicode_CompareWithASCIIString(type, "ok") == 0) {
                ev = 1; is_ok = 1;
            } else if (PyUnicode_CompareWithASCIIString(type, "info") == 0) {
                ev = 1; is_info = 1;
            } else if (PyUnicode_CompareWithASCIIString(type, "fail") == 0) {
                ev = 1; is_fail = 1;
            }
        }
        PyObject *process = PyDict_GetItemString(op, "process");
        if (!process) process = Py_None;
        if (ev >= 0) {
            /* previous-event-of-same-process rule (columnar pass A) */
            PyObject *prev = PyDict_GetItemWithError(c.state, process);
            if (!prev && PyErr_Occurred()) {
                /* unhashable process: Python path raises too -> bail */
                PyErr_Clear();
                out = OUT_BAIL;
                goto done;
            }
            if (ev == 1 && prev) {
                /* prev is always a PyLong WE stored below (i<<1|bit,
                 * i a list index): in-range, cannot fail.
                 * lint: ignore[jtn-errcheck] */
                long long packed = PyLong_AsLongLong(prev);
                if (packed & 1) c.inv_pos[i] = packed >> 1;
            }
            PyObject *now = PyLong_FromLongLong(((long long)i << 1) |
                                                (ev == 0 ? 1 : 0));
            if (!now) { out = OUT_ERR; goto done; }
            if (PyDict_SetItem(c.state, process, now) < 0) {
                Py_DECREF(now);
                PyErr_Clear();
                out = OUT_BAIL; /* unhashable process */
                goto done;
            }
            Py_DECREF(now);
        }
        int proc_is_int = PyLong_Check(process); /* isinstance(p, int) */
        if (is_ok && proc_is_int) {
            if (vpush(&c.ok_pos, i)) { out = OUT_ERR; goto done; }
        } else if (is_info && proc_is_int) {
            if (vpush(&c.info_pos, i)) { out = OUT_ERR; goto done; }
        } else if (is_fail) {
            if (vpush(&c.fail_pos, i)) { out = OUT_ERR; goto done; }
        }
    }

    n_ok = c.ok_pos.n;
    n = n_ok + c.info_pos.n;
    if (n == 0 || n >= ((Py_ssize_t)1 << 31)) { out = OUT_BAIL; goto done; }

    /* ---- pass B: flatten micro-ops (oks then infos) ----------------- */
    for (Py_ssize_t j = 0; j < n; j++) {
        Py_ssize_t pos = j < n_ok ? c.ok_pos.d[j] : c.info_pos.d[j - n_ok];
        PyObject *op = PyList_GET_ITEM(history, pos);
        if (PyList_Append(c.txns, op) < 0) { out = OUT_ERR; goto done; }
        /* node_proc must fit int64 (Python: np.asarray(..., int64)) */
        PyObject *process = PyDict_GetItemString(op, "process");
        int ovf = 0;
        long long x = process ? PyLong_AsLongLongAndOverflow(process, &ovf)
                              : -1;
        if (!process || ovf || (x == -1 && PyErr_Occurred())) {
            PyErr_Clear();
            out = OUT_BAIL;
            goto done;
        }
        if (vpush(&node_proc_v, x)) { out = OUT_ERR; goto done; }
        int rc = flatten_txn(&c, op, j);
        if (rc != OUT_OK) { out = rc; goto done; }
    }

    /* ---- fail ops' appends (kid() continuation semantics) ----------- */
    for (Py_ssize_t fi = 0; fi < c.fail_pos.n; fi++) {
        PyObject *op = PyList_GET_ITEM(history, c.fail_pos.d[fi]);
        PyObject *value = PyDict_GetItemString(op, "value");
        if (!value) continue;
        int truth = PyObject_IsTrue(value);
        if (truth < 0) { out = OUT_ERR; goto done; }
        if (!truth) continue;
        PyObject **items;
        Py_ssize_t nm;
        if (PyList_CheckExact(value)) {
            items = ((PyListObject *)value)->ob_item;
            nm = PyList_GET_SIZE(value);
        } else if (PyTuple_CheckExact(value)) {
            items = ((PyTupleObject *)value)->ob_item;
            nm = PyTuple_GET_SIZE(value);
        } else { out = OUT_BAIL; goto done; }
        for (Py_ssize_t mi = 0; mi < nm; mi++) {
            PyObject *m = items[mi];
            PyObject **mit;
            Py_ssize_t ml;
            if (PyList_CheckExact(m)) {
                mit = ((PyListObject *)m)->ob_item;
                ml = PyList_GET_SIZE(m);
            } else if (PyTuple_CheckExact(m)) {
                mit = ((PyTupleObject *)m)->ob_item;
                ml = PyTuple_GET_SIZE(m);
            } else { out = OUT_BAIL; goto done; }
            if (ml < 1 || !PyUnicode_CheckExact(mit[0])) {
                out = OUT_BAIL; goto done;
            }
            if (PyUnicode_CompareWithASCIIString(mit[0], "append") != 0)
                continue;
            if (ml < 3 || !PyLong_CheckExact(mit[1])) {
                out = OUT_BAIL; goto done;
            }
            int64_t kid = intern_kid(&c, mit[1]);
            if (kid == -1) { out = OUT_BAIL; goto done; }
            if (kid == -2) { out = OUT_ERR; goto done; }
            int64_t val;
            if (as_i64(mit[2], &val) < 0 || val < 0 || val >= MAX_VAL) {
                out = OUT_BAIL; goto done;
            }
            if (vpush(&c.f_kid, kid) || vpush(&c.f_val, val)) {
                out = OUT_ERR; goto done;
            }
        }
    }

    /* ---- spines: first maximal-length ok read per key ---------------- */
    {
        Py_ssize_t nk = c.nk;
        c.best_len = (int64_t *)malloc((size_t)(nk > 0 ? nk : 1) * 8);
        c.best_row = (int64_t *)malloc((size_t)(nk > 0 ? nk : 1) * 8);
        c.soff = (int64_t *)malloc((size_t)(nk > 0 ? nk : 1) * 8);
        c.slen = (int64_t *)malloc((size_t)(nk > 0 ? nk : 1) * 8);
        if (!c.best_len || !c.best_row || !c.soff || !c.slen) {
            PyErr_NoMemory();
            out = OUT_ERR;
            goto done;
        }
        for (Py_ssize_t k = 0; k < nk; k++) {
            c.best_len[k] = -1;
            c.best_row[k] = -1;
            c.soff[k] = -1;
            c.slen[k] = 0;
        }
        for (Py_ssize_t j = 0; j < c.r_txn.n; j++) {
            if (c.r_txn.d[j] >= (int64_t)n_ok) continue; /* info reads */
            int64_t k = c.r_kid.d[j];
            if (c.r_len.d[j] > c.best_len[k]) {
                c.best_len[k] = c.r_len.d[j];
                c.best_row[k] = j;
            }
        }
        /* S_concat / s_kid / soff / slen in kid order (matches the numpy
         * sort-by-kid layout) */
        for (Py_ssize_t k = 0; k < nk; k++) {
            if (c.best_row[k] < 0) continue;
            PyObject *p = PyList_GET_ITEM(c.payloads, c.best_row[k]);
            Py_ssize_t plen = PyList_GET_SIZE(p);
            c.soff[k] = c.s_concat.n;
            c.slen[k] = plen;
            for (Py_ssize_t e = 0; e < plen; e++) {
                int64_t v;
                if (as_i64(PyList_GET_ITEM(p, e), &v) < 0 || v < 0 ||
                    v >= MAX_VAL) {
                    out = OUT_BAIL; /* non-int/out-of-range spine element */
                    goto done;
                }
                if (vpush(&c.s_concat, v) || vpush(&c.s_kid, k)) {
                    out = OUT_ERR;
                    goto done;
                }
            }
        }
    }

    /* ---- prefix verification against spines -------------------------- */
    for (Py_ssize_t j = 0; j < c.r_txn.n; j++) {
        if (c.r_txn.d[j] >= (int64_t)n_ok) continue;
        int64_t k = c.r_kid.d[j];
        PyObject *p = PyList_GET_ITEM(c.payloads, j);
        PyObject *sp = PyList_GET_ITEM(c.payloads, c.best_row[k]);
        if (p == sp) continue;
        Py_ssize_t plen = PyList_GET_SIZE(p);
        int clean = plen <= PyList_GET_SIZE(sp);
        for (Py_ssize_t e = 0; clean && e < plen; e++) {
            PyObject *a = PyList_GET_ITEM(p, e);
            PyObject *b = PyList_GET_ITEM(sp, e);
            if (a == b) continue;
            int eq = PyObject_RichCompareBool(a, b, Py_EQ);
            if (eq < 0) {
                PyErr_Clear();
                out = OUT_BAIL; /* incomparable payloads: Python path */
                goto done;
            }
            clean = eq;
        }
        if (!clean) {
            PyObject *jj = PyLong_FromSsize_t(j);
            if (!jj || PyList_Append(c.scrutiny, jj) < 0) {
                Py_XDECREF(jj);
                out = OUT_ERR;
                goto done;
            }
            Py_DECREF(jj);
        }
    }

    /* ---- package ----------------------------------------------------- */
    {
        vec np_v, ni_v;
        memset(&np_v, 0, sizeof(np_v));
        memset(&ni_v, 0, sizeof(ni_v));
        int push_fail = 0;
        for (Py_ssize_t j = 0; j < n && !push_fail; j++) {
            Py_ssize_t pos = j < n_ok ? c.ok_pos.d[j]
                                      : c.info_pos.d[j - n_ok];
            push_fail = vpush(&np_v, pos) || vpush(&ni_v, c.inv_pos[pos]);
        }
        if (push_fail) {
            vfree(&np_v);
            vfree(&ni_v);
            PyErr_NoMemory();
            out = OUT_ERR;
            goto done;
        }
        result = PyTuple_New(25);
        if (!result) {
            vfree(&np_v);
            vfree(&ni_v);
            out = OUT_ERR;
            goto done;
        }
        int slot = 0, bad = 0;
        /* SETNEW consumes o; a NULL o marks failure, slot gets None */
#define SETNEW(o)                                                      \
        do {                                                           \
            PyObject *tmp_ = (o);                                      \
            if (!tmp_) { bad = 1; tmp_ = Py_None; Py_INCREF(tmp_); }   \
            PyTuple_SET_ITEM(result, slot++, tmp_);                    \
        } while (0)
        SETNEW(PyLong_FromSsize_t(n_ok));
        SETNEW(PyLong_FromSsize_t(c.nk));
        SETNEW(vbytes(&np_v));
        SETNEW(vbytes(&ni_v));
        SETNEW(vbytes(&node_proc_v));
        SETNEW((Py_INCREF(c.txns), c.txns));
        SETNEW(vbytes(&c.a_txn));
        SETNEW(vbytes(&c.a_kid));
        SETNEW(vbytes(&c.a_val));
        SETNEW(vbytes(&c.a_mi));
        SETNEW(vbytes(&c.r_txn));
        SETNEW(vbytes(&c.r_kid));
        SETNEW(vbytes(&c.r_mi));
        SETNEW(vbytes(&c.r_len));
        SETNEW(vbytes(&c.r_last));
        SETNEW((Py_INCREF(c.payloads), c.payloads));
        SETNEW((Py_INCREF(c.raw_key), c.raw_key));
        SETNEW(vbytes(&c.f_kid));
        SETNEW(vbytes(&c.f_val));
        SETNEW(vbytes(&c.s_concat));
        SETNEW(vbytes(&c.s_kid));
        SETNEW(PyByteArray_FromStringAndSize((char *)c.soff, c.nk * 8));
        SETNEW(PyByteArray_FromStringAndSize((char *)c.slen, c.nk * 8));
        SETNEW(PyByteArray_FromStringAndSize((char *)c.best_row, c.nk * 8));
        SETNEW((Py_INCREF(c.scrutiny), c.scrutiny));
#undef SETNEW
        vfree(&np_v);
        vfree(&ni_v);
        if (bad) {
            if (!PyErr_Occurred()) PyErr_NoMemory();
            out = OUT_ERR;
        } else {
            out = OUT_OK;
        }
    }

done:
    ctx_free(&c);
    vfree(&node_proc_v);
    if (out == OUT_OK) return result;
    Py_XDECREF(result);
    if (out == OUT_BAIL) {
        if (PyErr_Occurred()) PyErr_Clear();
        Py_RETURN_NONE;
    }
    /* OUT_ERR: an exception must be set — the vpush (realloc) failure
     * paths reach here bare, and a NULL return without an exception
     * would surface as a misleading SystemError */
    if (!PyErr_Occurred()) PyErr_NoMemory();
    return NULL;
}

static PyMethodDef methods[] = {
    {"parse", parse, METH_VARARGS,
     "parse(history) -> tuple | None\n"
     "C-speed pass A/B + spine/prefix of the columnar Elle builder."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_columnar_c_torch",
    "C-speed columnar history parser (see columnar_ext.c)", -1, methods,
    NULL, NULL, NULL, NULL};

#ifdef __cplusplus
extern "C" {
#endif
PyMODINIT_FUNC PyInit__columnar_c_torch(void) {
    return PyModule_Create(&moduledef);
}
#ifdef __cplusplus
}
#endif

/* C-speed columnar history parser and host ingest spine: the port's
 * copy of jepsen_tpu/native/columnar_ext.c without builder_extend and
 * sim_lane (their callers, IncrementalHistoryBuilder and the simulated
 * scheduler, are not in the port).
 *
 * parse (:1-527: the vec helpers, as_i64, ctx, intern_kid, flatten_txn
 * and parse): one tight C pass over the PyObject history does the event
 * pairing, micro-op flattening, key interning, spine selection and
 * prefix verification that jepsen_tpu_torch/elle/columnar.py's numpy
 * front (_build_py) does, bit for bit; any input outside the fast regime
 * returns None and the caller takes the numpy front.
 *
 * The spine (ingest_chunk, register_encode, register_add_encode,
 * frontier_absorb): the WAL tail -> parse -> live register encode ->
 * frontier loop of the live checker, dispatched by
 * jepsen_tpu_torch/history_ir/ingest.py. The reference's register_add
 * (the add pass alone) is left out: its one caller that the fused
 * register_add_encode does not cover is the reference's first-use
 * probe, which the port does not have.
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

/* copied from jepsen_tpu/native/columnar_ext.c:529-601 */
/* ====================================================================
 * Host ingest spine
 *
 * Four entry points move the WAL hot loop (newline scan, JSON parse,
 * live register encode, frontier absorb) off the interpreted path:
 *
 *   ingest_chunk         raw bytes -> ops list (torn-line contract of
 *                        read_jsonl_tolerant / WalTailer.poll, per line)
 *   register_encode      resolution state -> ListStream event columns
 *   register_add_encode  ops -> LiveRegisterEncoder resolution state
 *                        and the encode, in one walk of a chunk
 *   frontier_absorb      event columns -> FrontierSession config closure
 *
 * Every function mutates (or returns replacements for) the SAME
 * Python-level state its pure-Python twin owns, so the two
 * implementations interleave freely mid-stream and a per-op/per-line
 * regime miss falls back to the Python twin with bit-identical state
 * (jepsen_tpu_torch/history_ir/ingest.py dispatches). The differential
 * suite tests/test_torch_ingest.py pins each one to its twin and to the
 * JAX package's.
 * ==================================================================== */

/* shared singletons, created once in PyInit */
static PyObject *g_key_cache;  /* str -> str: shared key/short-string pool */
static PyObject *g_s_type, *g_s_process, *g_s_f, *g_s_value, *g_s_time,
    *g_s_index, *g_s_read, *g_s_ok, *g_s_unhash, *g_s_invoke;
static PyObject *g_keep, *g_drop; /* ("keep",) / ("drop",) */
static PyObject *g_int[4];        /* 0..3 */
static PyObject *g_m1;            /* -1 */

static int spine_init(void) {
    if (g_key_cache) return 0;
#define MKSTR(var, lit)                   \
    do {                                  \
        var = PyUnicode_InternFromString(lit); \
        if (!var) return -1;              \
    } while (0)
    g_key_cache = PyDict_New();
    if (!g_key_cache) return -1;
    MKSTR(g_s_type, "type");
    MKSTR(g_s_process, "process");
    MKSTR(g_s_f, "f");
    MKSTR(g_s_value, "value");
    MKSTR(g_s_time, "time");
    MKSTR(g_s_index, "index");
    MKSTR(g_s_read, "read");
    MKSTR(g_s_ok, "ok");
    MKSTR(g_s_unhash, "__unhashable__");
    MKSTR(g_s_invoke, "invoke");
#undef MKSTR
    {
        PyObject *k = PyUnicode_InternFromString("keep");
        PyObject *d = PyUnicode_InternFromString("drop");
        if (!k || !d) {
            Py_XDECREF(k);
            Py_XDECREF(d);
            return -1;
        }
        g_keep = PyTuple_Pack(1, k);
        g_drop = PyTuple_Pack(1, d);
        Py_DECREF(k);
        Py_DECREF(d);
        if (!g_keep || !g_drop) return -1;
    }
    for (int i = 0; i < 4; i++) {
        g_int[i] = PyLong_FromLong(i);
        if (!g_int[i]) return -1;
    }
    g_m1 = PyLong_FromLong(-1);
    if (!g_m1) return -1;
    return 0;
}

/* copied from jepsen_tpu/native/columnar_ext.c:602-1224 */
/* -------------------- JSON line parser -------------------------------
 * Strict-by-construction: anything this parser is not 100% sure it
 * reproduces exactly as CPython's json.loads would (escapes gone wrong,
 * invalid UTF-8, oversized numbers, depth) flags `bail`, and the caller
 * hands the LINE to the Python fallback. Success must be provably
 * identical to json.loads on the same line. */

typedef struct {
    const unsigned char *p, *end;
    int bail;  /* 1 => caller falls back to Python for this line */
    int depth;
} JP;

#define JP_MAX_DEPTH 64

static void jp_ws(JP *j) {
    while (j->p < j->end) {
        unsigned char c = *j->p;
        if (c == ' ' || c == '\t' || c == '\n' || c == '\r')
            j->p++;
        else
            break;
    }
}

/* strict UTF-8 decode of one codepoint; returns byte length or -1 */
static int u8cp(const unsigned char *p, const unsigned char *end,
                Py_UCS4 *cp) {
    unsigned char c = *p;
    if (c < 0x80) {
        *cp = c;
        return 1;
    }
    if ((c >> 5) == 0x6) {
        if (end - p < 2 || (p[1] & 0xC0) != 0x80) return -1;
        Py_UCS4 v = ((Py_UCS4)(c & 0x1F) << 6) | (p[1] & 0x3F);
        if (v < 0x80) return -1;
        *cp = v;
        return 2;
    }
    if ((c >> 4) == 0xE) {
        if (end - p < 3 || (p[1] & 0xC0) != 0x80 || (p[2] & 0xC0) != 0x80)
            return -1;
        Py_UCS4 v = ((Py_UCS4)(c & 0x0F) << 12) |
                    ((Py_UCS4)(p[1] & 0x3F) << 6) | (p[2] & 0x3F);
        if (v < 0x800 || (v >= 0xD800 && v <= 0xDFFF)) return -1;
        *cp = v;
        return 3;
    }
    if ((c >> 3) == 0x1E) {
        if (end - p < 4 || (p[1] & 0xC0) != 0x80 ||
            (p[2] & 0xC0) != 0x80 || (p[3] & 0xC0) != 0x80)
            return -1;
        Py_UCS4 v = ((Py_UCS4)(c & 0x07) << 18) |
                    ((Py_UCS4)(p[1] & 0x3F) << 12) |
                    ((Py_UCS4)(p[2] & 0x3F) << 6) | (p[3] & 0x3F);
        if (v < 0x10000 || v > 0x10FFFF) return -1;
        *cp = v;
        return 4;
    }
    return -1;
}

static int hex4(const unsigned char *p, unsigned *out) {
    unsigned v = 0;
    for (int i = 0; i < 4; i++) {
        unsigned char c = p[i];
        v <<= 4;
        if (c >= '0' && c <= '9')
            v |= c - '0';
        else if (c >= 'a' && c <= 'f')
            v |= c - 'a' + 10;
        else if (c >= 'A' && c <= 'F')
            v |= c - 'A' + 10;
        else
            return -1;
    }
    *out = v;
    return 0;
}

/* route short strings through the shared pool: repeated keys/values
 * ("type", "invoke", "write", ...) collapse to one object with a
 * cached hash, like json's own per-scan key memo but cross-line.
 * Consumes s; returns a new reference. */
static PyObject *pool_str(PyObject *s) {
    if (!s || PyUnicode_GET_LENGTH(s) > 32) return s;
    PyObject *got = PyDict_GetItemWithError(g_key_cache, s);
    if (got) {
        Py_INCREF(got);
        Py_DECREF(s);
        return got;
    }
    if (PyErr_Occurred()) {
        Py_DECREF(s);
        return NULL;
    }
    if (PyDict_GET_SIZE(g_key_cache) < 4096 &&
        PyDict_SetItem(g_key_cache, s, s) < 0) {
        Py_DECREF(s);
        return NULL;
    }
    return s;
}

/* byte-keyed cache for short escape-free strings: repeated keys and
 * enum-ish values ("type", "invoke", "write", ...) resolve to their
 * pooled PyUnicode without constructing a new object per line. First
 * come, first kept — no eviction, bounded size. */
#define BK_SLOTS 2048 /* power of two */
#define BK_MAXLEN 24
typedef struct {
    unsigned char len;
    unsigned char b[BK_MAXLEN];
    PyObject *s; /* owned; lives as long as the module */
} bkent;
static bkent g_bk[BK_SLOTS];

static PyObject *bk_lookup(const unsigned char *p, Py_ssize_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (Py_ssize_t i = 0; i < n; i++) h = (h ^ p[i]) * 1099511628211ULL;
    size_t idx = (size_t)h & (BK_SLOTS - 1);
    for (int probe = 0; probe < 8; probe++) {
        bkent *e = &g_bk[(idx + probe) & (BK_SLOTS - 1)];
        if (!e->s) {
            /* miss with room: construct, pool, insert */
            PyObject *u = PyUnicode_DecodeUTF8((const char *)p, n, NULL);
            if (!u) return NULL; /* ascii input: shouldn't fail */
            u = pool_str(u);
            if (!u) return NULL;
            e->len = (unsigned char)n;
            memcpy(e->b, p, (size_t)n);
            Py_INCREF(u); /* cache's own reference */
            e->s = u;
            return u;
        }
        if (e->len == n && memcmp(e->b, p, (size_t)n) == 0) {
            Py_INCREF(e->s);
            return e->s;
        }
    }
    /* table neighborhood full: construct without caching */
    PyObject *u = PyUnicode_DecodeUTF8((const char *)p, n, NULL);
    if (!u) return NULL;
    return pool_str(u);
}

/* j->p at the opening quote */
/* lint: ignore[jtn-bounds-guard] — the UCS4 buffer holds cap = q - s
 * codepoints and every loop arm consumes >= 1 input byte per emitted
 * codepoint, so n < cap on every buf[n++] (the fuzz harness hammers
 * exactly this arithmetic under ASan). */
static PyObject *jp_string(JP *j) {
    const unsigned char *s = j->p + 1, *q = s;
    int esc = 0, hi = 0;
    while (q < j->end) {
        unsigned char c = *q;
        if (c == '"') break;
        if (c == '\\') {
            esc = 1;
            q += 2;  /* skip escaped char (never a quote terminator) */
            continue;
        }
        if (c < 0x20) {  /* strict json rejects raw control chars */
            j->bail = 1;
            return NULL;
        }
        if (c >= 0x80) hi = 1;
        q++;
    }
    if (q >= j->end) {  /* unterminated (or escape ran off the end) */
        j->bail = 1;
        return NULL;
    }
    j->p = q + 1;
    if (!esc && !hi && q - s <= BK_MAXLEN)
        return bk_lookup(s, (Py_ssize_t)(q - s));
    if (!esc) {
        PyObject *u = PyUnicode_DecodeUTF8((const char *)s,
                                           (Py_ssize_t)(q - s), NULL);
        if (!u) {
            if (PyErr_ExceptionMatches(PyExc_UnicodeDecodeError)) {
                PyErr_Clear();
                j->bail = 1; /* invalid utf-8: Python 'replace' path */
            }
            return NULL;
        }
        (void)hi;
        return pool_str(u);
    }
    /* escape slow path: decode into a UCS4 buffer */
    Py_ssize_t cap = (Py_ssize_t)(q - s);
    Py_UCS4 *buf = (Py_UCS4 *)malloc(cap ? (size_t)cap * 4 : 4);
    if (!buf) {
        PyErr_NoMemory();
        return NULL;
    }
    Py_ssize_t n = 0;
    const unsigned char *r = s;
    while (r < q) {
        unsigned char c = *r;
        if (c == '\\') {
            r++;
            unsigned char e = *r++;
            Py_UCS4 cp;
            switch (e) {
            case '"': cp = '"'; break;
            case '\\': cp = '\\'; break;
            case '/': cp = '/'; break;
            case 'b': cp = '\b'; break;
            case 'f': cp = '\f'; break;
            case 'n': cp = '\n'; break;
            case 'r': cp = '\r'; break;
            case 't': cp = '\t'; break;
            case 'u': {
                unsigned v;
                if (q - r < 4 || hex4(r, &v) < 0) goto bail;
                r += 4;
                cp = v;
                /* combine surrogate pairs; lone surrogates kept,
                 * exactly like json.decoder.scanstring */
                if (v >= 0xD800 && v <= 0xDBFF && q - r >= 6 &&
                    r[0] == '\\' && r[1] == 'u') {
                    unsigned lo;
                    if (hex4(r + 2, &lo) == 0 && lo >= 0xDC00 &&
                        lo <= 0xDFFF) {
                        cp = 0x10000 + (((v - 0xD800) << 10) |
                                        (lo - 0xDC00));
                        r += 6;
                    }
                }
                break;
            }
            default:
                goto bail;
            }
            buf[n++] = cp;
        } else if (c < 0x80) {
            buf[n++] = c;
            r++;
        } else {
            Py_UCS4 cp;
            int len = u8cp(r, q, &cp);
            if (len < 0) goto bail;
            buf[n++] = cp;
            r += len;
        }
    }
    {
        PyObject *u = PyUnicode_FromKindAndData(PyUnicode_4BYTE_KIND, buf,
                                                n);
        free(buf);
        /* buf already freed; a MemoryError here must propagate as an
         * ERROR, while the bail label means "tolerant re-parse" —
         * routing through it would misfile the failure.
         * lint: ignore[jtn-cleanup-return] */
        if (!u) return NULL;
        return pool_str(u);
    }
bail:
    free(buf);
    j->bail = 1;
    return NULL;
}

static PyObject *jp_number(JP *j) {
    const unsigned char *s = j->p, *q = s;
    int isflt = 0;
    if (q < j->end && *q == '-') q++;
    if (q >= j->end) {
        j->bail = 1;
        return NULL;
    }
    if (*q == '0') {
        q++;
    } else if (*q >= '1' && *q <= '9') {
        while (q < j->end && *q >= '0' && *q <= '9') q++;
    } else {
        j->bail = 1; /* includes -Infinity (handled by caller) */
        return NULL;
    }
    if (q < j->end && *q == '.') {
        isflt = 1;
        q++;
        if (q >= j->end || *q < '0' || *q > '9') {
            j->bail = 1;
            return NULL;
        }
        while (q < j->end && *q >= '0' && *q <= '9') q++;
    }
    if (q < j->end && (*q == 'e' || *q == 'E')) {
        isflt = 1;
        q++;
        if (q < j->end && (*q == '+' || *q == '-')) q++;
        if (q >= j->end || *q < '0' || *q > '9') {
            j->bail = 1;
            return NULL;
        }
        while (q < j->end && *q >= '0' && *q <= '9') q++;
    }
    Py_ssize_t len = (Py_ssize_t)(q - s);
    if (len >= 63) { /* absurd token: let Python decide */
        j->bail = 1;
        return NULL;
    }
    j->p = q;
    char buf[64];
    memcpy(buf, s, (size_t)len);
    buf[len] = 0;
    if (!isflt) {
        if (len <= 18) { /* fits int64 without overflow checks */
            int64_t v = 0;
            const char *t = buf;
            int neg = (*t == '-');
            if (neg) t++;
            while (*t) v = v * 10 + (*t++ - '0');
            return PyLong_FromLongLong(neg ? -v : v);
        }
        return PyLong_FromString(buf, NULL, 10);
    }
    double d = PyOS_string_to_double(buf, NULL, NULL);
    if (d == -1.0 && PyErr_Occurred()) {
        PyErr_Clear();
        j->bail = 1;
        return NULL;
    }
    return PyFloat_FromDouble(d);
}

static int jp_lit(JP *j, const char *lit, size_t n) {
    if ((size_t)(j->end - j->p) < n || memcmp(j->p, lit, n) != 0) return 0;
    j->p += n;
    return 1;
}

static PyObject *jp_value(JP *j) {
    jp_ws(j);
    if (j->p >= j->end) {
        j->bail = 1;
        return NULL;
    }
    unsigned char c = *j->p;
    switch (c) {
    case '{': {
        if (++j->depth > JP_MAX_DEPTH) {
            j->bail = 1;
            return NULL;
        }
        PyObject *d = PyDict_New();
        if (!d) return NULL;
        j->p++;
        jp_ws(j);
        if (j->p < j->end && *j->p == '}') {
            j->p++;
            j->depth--;
            return d;
        }
        for (;;) {
            jp_ws(j);
            if (j->p >= j->end || *j->p != '"') goto obail;
            PyObject *k = jp_string(j);
            if (!k) {
                Py_DECREF(d);
                /* d released inline; obail would double-release.
                 * lint: ignore[jtn-cleanup-return] */
                return NULL;
            }
            jp_ws(j);
            if (j->p >= j->end || *j->p != ':') {
                Py_DECREF(k);
                goto obail;
            }
            j->p++;
            PyObject *v = jp_value(j);
            if (!v) {
                Py_DECREF(k);
                Py_DECREF(d);
                /* k, d released inline (obail releases d alone).
                 * lint: ignore[jtn-cleanup-return] */
                return NULL;
            }
            int rc = PyDict_SetItem(d, k, v); /* dup keys: last wins */
            Py_DECREF(k);
            Py_DECREF(v);
            if (rc < 0) {
                Py_DECREF(d);
                /* d released inline; error already set by SetItem.
                 * lint: ignore[jtn-cleanup-return] */
                return NULL;
            }
            jp_ws(j);
            if (j->p < j->end && *j->p == ',') {
                j->p++;
                continue;
            }
            if (j->p < j->end && *j->p == '}') {
                j->p++;
                j->depth--;
                return d;
            }
            goto obail;
        }
    obail:
        Py_DECREF(d);
        j->bail = 1;
        return NULL;
    }
    case '[': {
        if (++j->depth > JP_MAX_DEPTH) {
            j->bail = 1;
            return NULL;
        }
        PyObject *l = PyList_New(0);
        if (!l) return NULL;
        j->p++;
        jp_ws(j);
        if (j->p < j->end && *j->p == ']') {
            j->p++;
            j->depth--;
            return l;
        }
        for (;;) {
            PyObject *v = jp_value(j);
            if (!v) {
                Py_DECREF(l);
                return NULL;
            }
            int rc = PyList_Append(l, v);
            Py_DECREF(v);
            if (rc < 0) {
                Py_DECREF(l);
                return NULL;
            }
            jp_ws(j);
            if (j->p < j->end && *j->p == ',') {
                j->p++;
                continue;
            }
            if (j->p < j->end && *j->p == ']') {
                j->p++;
                j->depth--;
                return l;
            }
            Py_DECREF(l);
            j->bail = 1;
            return NULL;
        }
    }
    case '"':
        return jp_string(j);
    case 't':
        if (jp_lit(j, "true", 4)) Py_RETURN_TRUE;
        j->bail = 1;
        return NULL;
    case 'f':
        if (jp_lit(j, "false", 5)) Py_RETURN_FALSE;
        j->bail = 1;
        return NULL;
    case 'n':
        if (jp_lit(j, "null", 4)) Py_RETURN_NONE;
        j->bail = 1;
        return NULL;
    case 'N': /* json.loads accepts NaN/Infinity by default */
        if (jp_lit(j, "NaN", 3)) return PyFloat_FromDouble(Py_NAN);
        j->bail = 1;
        return NULL;
    case 'I':
        if (jp_lit(j, "Infinity", 8))
            return PyFloat_FromDouble(Py_HUGE_VAL);
        j->bail = 1;
        return NULL;
    case '-':
        if (j->end - j->p >= 9 && j->p[1] == 'I') {
            if (jp_lit(j, "-Infinity", 9))
                return PyFloat_FromDouble(-Py_HUGE_VAL);
            j->bail = 1;
            return NULL;
        }
        return jp_number(j);
    default:
        if (c >= '0' && c <= '9') return jp_number(j);
        j->bail = 1;
        return NULL;
    }
}

/* ingest_chunk(data: bytes, final: int, fallback, skip, torn)
 *   -> (ops: list, consumed: int, torn: int, truncated: int)
 *
 * Newline scan + per-line parse with WalTailer.poll's tolerant
 * contract: whitespace-only lines skipped uncounted, terminated
 * malformed lines counted torn, the unterminated tail left unconsumed
 * unless `final` (then dropped + counted). Lines this parser can't
 * guarantee go to `fallback(line_bytes)`, which returns the parsed op,
 * `skip` (whitespace-only after decode) or `torn` (JSONDecodeError). */
/* line-template cache: whole-line memo for the op-record steady state.
 * A WAL under load repeats a small set of line shapes (same keys, enum
 * values, small value domains), so a byte-identical line can skip the
 * parser: the result is PyDict_Copy of the cached template (CPython
 * clones the keys table wholesale) plus a fresh one-level copy of any
 * top-level list value — lists are mutable, and handing two ops the
 * SAME list object would be observable aliasing json.loads never
 * produces. Only lines whose parse is a flat dict of immutable scalars
 * (or lists thereof) are cached; everything else misses every time at
 * the cost of one hash+probe. First come, first kept — no eviction. */
#define LT_SLOTS 1024 /* power of two */
#define LT_MAXLEN 96
#define LT_MAXLISTS 4
typedef struct {
    unsigned char len;
    unsigned char nlists;
    unsigned char b[LT_MAXLEN];
    PyObject *tmpl;                  /* owned template dict */
    PyObject *listkeys[LT_MAXLISTS]; /* owned; values needing a copy */
} ltent;
static ltent g_lt[LT_SLOTS];

static uint64_t lt_hash(const unsigned char *p, Py_ssize_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (Py_ssize_t i = 0; i < n; i++) h = (h ^ p[i]) * 1099511628211ULL;
    return h;
}

static int lt_scalar_ok(PyObject *v) {
    return v == Py_None || v == Py_True || v == Py_False ||
           PyLong_CheckExact(v) || PyFloat_CheckExact(v) ||
           PyUnicode_CheckExact(v);
}

/* new ref on hit; NULL on miss (no exception) or on error (exception
 * set — caller must check PyErr_Occurred) */
static PyObject *lt_lookup(const unsigned char *p, Py_ssize_t n) {
    if (n > LT_MAXLEN || n == 0) return NULL;
    size_t idx = (size_t)lt_hash(p, n) & (LT_SLOTS - 1);
    for (int probe = 0; probe < 4; probe++) {
        ltent *e = &g_lt[(idx + probe) & (LT_SLOTS - 1)];
        if (!e->tmpl) return NULL; /* empty slot: definitive miss */
        if (e->len != n || memcmp(e->b, p, (size_t)n) != 0) continue;
        PyObject *d = PyDict_Copy(e->tmpl);
        if (!d) return NULL;
        for (int i = 0; i < e->nlists; i++) {
            PyObject *lv = PyDict_GetItemWithError(d, e->listkeys[i]);
            if (!lv) {
                Py_DECREF(d);
                if (!PyErr_Occurred())
                    PyErr_SetString(PyExc_SystemError, "lt key vanished");
                return NULL;
            }
            PyObject *c = PyList_GetSlice(lv, 0, PyList_GET_SIZE(lv));
            if (!c || PyDict_SetItem(d, e->listkeys[i], c) < 0) {
                Py_XDECREF(c);
                Py_DECREF(d);
                return NULL;
            }
            Py_DECREF(c);
        }
        return d;
    }
    return NULL;
}

/* best-effort: cache `d` (the fresh parse of line p[:n]) when its shape
 * is safely copyable; failures just skip the insert */
static void lt_maybe_insert(const unsigned char *p, Py_ssize_t n,
                            PyObject *d) {
    if (n > LT_MAXLEN || n == 0 || !PyDict_CheckExact(d)) return;
    PyObject *lk[LT_MAXLISTS];
    int nl = 0;
    PyObject *k, *v;
    Py_ssize_t pos = 0;
    while (PyDict_Next(d, &pos, &k, &v)) {
        if (!PyUnicode_CheckExact(k)) return;
        if (lt_scalar_ok(v)) continue;
        if (PyList_CheckExact(v)) {
            if (nl == LT_MAXLISTS) return;
            for (Py_ssize_t i = 0; i < PyList_GET_SIZE(v); i++)
                if (!lt_scalar_ok(PyList_GET_ITEM(v, i))) return;
            lk[nl++] = k;
            continue;
        }
        return; /* nested dict / exotic value: not cacheable */
    }
    size_t idx = (size_t)lt_hash(p, n) & (LT_SLOTS - 1);
    ltent *e = NULL;
    for (int probe = 0; probe < 4; probe++) {
        ltent *cand = &g_lt[(idx + probe) & (LT_SLOTS - 1)];
        if (!cand->tmpl) {
            e = cand;
            break;
        }
        if (cand->len == n && memcmp(cand->b, p, (size_t)n) == 0)
            return; /* already cached (racing inserts can't happen: GIL) */
    }
    if (!e) return; /* neighborhood full */
    /* the template must be isolated from the dict we hand the caller:
     * copy it, and give the copy its own list objects too */
    PyObject *t = PyDict_Copy(d);
    if (!t) {
        PyErr_Clear();
        return;
    }
    for (int i = 0; i < nl; i++) {
        PyObject *lv = PyDict_GetItemWithError(t, lk[i]);
        PyObject *c = lv ? PyList_GetSlice(lv, 0, PyList_GET_SIZE(lv))
                         : NULL;
        if (!c || PyDict_SetItem(t, lk[i], c) < 0) {
            Py_XDECREF(c);
            Py_DECREF(t);
            PyErr_Clear();
            return;
        }
        Py_DECREF(c);
    }
    e->len = (unsigned char)n;
    e->nlists = (unsigned char)nl;
    memcpy(e->b, p, (size_t)n);
    e->tmpl = t;
    for (int i = 0; i < nl; i++) {
        Py_INCREF(lk[i]);
        e->listkeys[i] = lk[i];
    }
}

/* copied from jepsen_tpu/native/columnar_ext.c:1225-1315 */
static PyObject *ingest_chunk(PyObject *self, PyObject *args) {
    (void)self;
    Py_buffer view;
    int final;
    PyObject *fallback, *skip_sent, *torn_sent;
    if (!PyArg_ParseTuple(args, "y*pOOO", &view, &final, &fallback,
                          &skip_sent, &torn_sent))
        return NULL;
    const unsigned char *data = (const unsigned char *)view.buf;
    Py_ssize_t len = view.len;
    PyObject *ops = PyList_New(0);
    if (!ops) {
        PyBuffer_Release(&view);
        return NULL;
    }
    Py_ssize_t pos = 0, consumed = 0;
    long torn = 0;
    int truncated = 0;
    while (pos < len) {
        const unsigned char *nl = (const unsigned char *)memchr(
            data + pos, '\n', (size_t)(len - pos));
        if (!nl) break;
        Py_ssize_t lstart = pos, lend = (Py_ssize_t)(nl - data);
        pos = lend + 1;
        consumed = pos;
        PyObject *hit = lt_lookup(data + lstart, lend - lstart);
        if (hit) {
            if (PyList_Append(ops, hit) < 0) {
                Py_DECREF(hit);
                goto err;
            }
            Py_DECREF(hit);
            continue;
        }
        if (PyErr_Occurred()) goto err;
        JP j;
        j.p = data + lstart;
        j.end = data + lend;
        j.bail = 0;
        j.depth = 0;
        jp_ws(&j);
        if (j.p >= j.end) continue; /* empty / json-ws-only line */
        PyObject *v = jp_value(&j);
        if (v) {
            jp_ws(&j);
            if (j.p >= j.end) { /* clean parse, no trailing garbage */
                lt_maybe_insert(data + lstart, lend - lstart, v);
                if (PyList_Append(ops, v) < 0) {
                    Py_DECREF(v);
                    goto err;
                }
                Py_DECREF(v);
                continue;
            }
            Py_DECREF(v); /* trailing garbage: json.loads would raise */
        } else if (!j.bail) {
            goto err; /* real exception (MemoryError etc.) */
        }
        /* fallback: Python decides parse / skip / torn for this line */
        {
            PyObject *line = PyBytes_FromStringAndSize(
                (const char *)(data + lstart), lend - lstart);
            if (!line) goto err;
            PyObject *r = PyObject_CallFunctionObjArgs(fallback, line,
                                                       NULL);
            Py_DECREF(line);
            if (!r) goto err;
            if (r == torn_sent) {
                torn++;
            } else if (r != skip_sent) {
                if (PyList_Append(ops, r) < 0) {
                    Py_DECREF(r);
                    goto err;
                }
            }
            Py_DECREF(r);
        }
    }
    if (final && consumed < len) {
        truncated = 1;
        torn++;
        consumed = len;
    }
    PyBuffer_Release(&view);
    return Py_BuildValue("(Nnli)", ops, consumed, torn, truncated);
err:
    PyBuffer_Release(&view);
    Py_DECREF(ops);
    return NULL;
}

/* copied from jepsen_tpu/native/columnar_ext.c:1316-1358 */
/* -------------------- canonical-column append ------------------------ */

/* mirrors history.Intern.id (keep_original=0) and
 * history_ir.ir.ValueIntern.id (keep_original=1); returns a NEW ref to
 * the id int, or NULL with an exception set */
static PyObject *intern_id_c(PyObject *ids, PyObject *table, PyObject *v,
                             int keep_original) {
    PyObject *key = v, *keyref = NULL;
    PyObject *got = PyDict_GetItemWithError(ids, v);
    if (!got && PyErr_Occurred()) {
        if (!PyErr_ExceptionMatches(PyExc_TypeError)) return NULL;
        PyErr_Clear(); /* unhashable: freeze by repr, like the twins */
        PyObject *r = PyObject_Repr(v);
        if (!r) return NULL;
        keyref = PyTuple_Pack(2, g_s_unhash, r);
        Py_DECREF(r);
        if (!keyref) return NULL;
        key = keyref;
        got = PyDict_GetItemWithError(ids, key);
        if (!got && PyErr_Occurred()) {
            Py_DECREF(keyref);
            return NULL;
        }
    }
    if (got) {
        Py_INCREF(got);
        Py_XDECREF(keyref);
        return got;
    }
    PyObject *idx = PyLong_FromSsize_t(PyList_GET_SIZE(table));
    if (!idx) {
        Py_XDECREF(keyref);
        return NULL;
    }
    if (PyDict_SetItem(ids, key, idx) < 0 ||
        PyList_Append(table, keep_original ? v : key) < 0) {
        Py_DECREF(idx);
        Py_XDECREF(keyref);
        return NULL;
    }
    Py_XDECREF(keyref);
    return idx;
}
/* copied from jepsen_tpu/native/columnar_ext.c:1545-2245, without
 * register_add */
/* -------------------- live register encoder --------------------------
 * Twins of LiveRegisterEncoder.add / encode_resolved
 * (history_ir/builder.py) for the default-args single-register session.
 * EV_INVOKE/EV_RETURN = 0/1 and CAS_F_READ/WRITE/CAS = 0/1/2 are
 * hardcoded; the Python wrapper asserts them at import. */

/* pop(d, key) -> new ref or NULL (check PyErr_Occurred) */
static PyObject *dict_pop(PyObject *d, PyObject *k) {
    /* the missing-vs-error split is this helper's documented contract:
     * every caller checks PyErr_Occurred on NULL (see enc_step_ok).
     * lint: ignore[jtn-errcheck] */
    PyObject *v = PyDict_GetItemWithError(d, k);
    if (!v) return NULL;
    Py_INCREF(v);
    if (PyDict_DelItem(d, k) < 0) {
        Py_DECREF(v);
        return NULL;
    }
    return v;
}

/* p is a usable process iff isinstance(p, int) and p >= 0 */
static int proc_ok(PyObject *p) {
    if (!p || !PyLong_Check(p)) return 0;
    int ovf = 0;
    long long v = PyLong_AsLongLongAndOverflow(p, &ovf);
    if (ovf > 0) return 1;  /* huge positive */
    if (ovf < 0) return 0;  /* huge negative */
    return v >= 0;
}

/* Shared encode-step machinery: ONE copy of the invoke/ok advance,
 * used by register_encode and the fused register_add_encode so the
 * two entries cannot drift. */
typedef struct {
    PyObject *outcome, *open_bp, *free_slots;
    PyObject *kindl, *slotl, *fl, *al, *bl, *oil;
    PyObject *ids, *table;
    Py_ssize_t next_slot, n_slots;
    int finalized;
} encst;

/* Invoke op at enc_ops index i. have=1 means outc is authoritative
 * (possibly NULL = unresolved); have=0 looks outcome[i] up.
 * Returns 0 advance, 1 stall, 2 bail, -1 error. */
static int enc_step_invoke(encst *E, PyObject *op, PyObject *p,
                           Py_ssize_t i, PyObject *outc, int have) {
    PyObject *i_obj = PyLong_FromSsize_t(i);
    if (!i_obj) return -1;
    if (!have) {
        outc = PyDict_GetItemWithError(E->outcome, i_obj);
        if (!outc && PyErr_Occurred()) {
            Py_DECREF(i_obj);
            return -1;
        }
    }
    int is_drop = 0, is_ok = 0;
    if (outc) {
        if (!PyTuple_CheckExact(outc) || PyTuple_GET_SIZE(outc) < 1) {
            Py_DECREF(i_obj);
            return 2;
        }
        PyObject *tag = PyTuple_GET_ITEM(outc, 0);
        if (PyUnicode_CheckExact(tag)) {
            is_drop = PyUnicode_CompareWithASCIIString(tag, "drop") == 0;
            is_ok = PyUnicode_CompareWithASCIIString(tag, "ok") == 0;
        }
    } else {
        if (!E->finalized) { /* stall: unresolved invoke */
            Py_DECREF(i_obj);
            return 1;
        }
        /* finalized: open read drops, open write/cas keeps */
        PyObject *fj = PyDict_GetItemWithError(op, g_s_f);
        if (!fj && PyErr_Occurred()) {
            Py_DECREF(i_obj);
            return -1;
        }
        int rd = PyObject_RichCompareBool(fj ? fj : Py_None, g_s_read,
                                          Py_EQ);
        if (rd < 0) {
            Py_DECREF(i_obj);
            return -1;
        }
        is_drop = rd;
    }
    if (is_drop) {
        Py_DECREF(i_obj);
        return 0;
    }
    /* pre-validate encode_args BEFORE mutating slot state so a bail
     * replays this op through Python from identical state */
    PyObject *fj = PyDict_GetItemWithError(op, g_s_f);
    if (!fj && PyErr_Occurred()) {
        Py_DECREF(i_obj);
        return -1;
    }
    long fcode = -1;
    if (fj && PyUnicode_CheckExact(fj)) {
        if (PyUnicode_CompareWithASCIIString(fj, "read") == 0)
            fcode = 0; /* CAS_F_READ */
        else if (PyUnicode_CompareWithASCIIString(fj, "write") == 0)
            fcode = 1; /* CAS_F_WRITE */
        else if (PyUnicode_CompareWithASCIIString(fj, "cas") == 0)
            fcode = 2; /* CAS_F_CAS */
    }
    PyObject *v = NULL;
    if (is_ok && PyTuple_GET_SIZE(outc) >= 2) {
        v = PyTuple_GET_ITEM(outc, 1);
    } else {
        v = PyDict_GetItemWithError(op, g_s_value);
        if (!v && PyErr_Occurred()) {
            Py_DECREF(i_obj);
            return -1;
        }
        if (!v) v = Py_None;
    }
    if (fcode < 0 ||
        (fcode == 2 &&
         !((PyList_CheckExact(v) && PyList_GET_SIZE(v) == 2) ||
           (PyTuple_CheckExact(v) && PyTuple_GET_SIZE(v) == 2)))) {
        Py_DECREF(i_obj);
        return 2; /* unknown f / non-pair cas: Python raises */
    }
    /* slot allocation */
    PyObject *s_obj;
    Py_ssize_t nfree = PyList_GET_SIZE(E->free_slots);
    if (nfree) {
        s_obj = PyList_GET_ITEM(E->free_slots, nfree - 1);
        Py_INCREF(s_obj);
        if (PyList_SetSlice(E->free_slots, nfree - 1, nfree, NULL) < 0) {
            Py_DECREF(s_obj);
            Py_DECREF(i_obj);
            return -1;
        }
    } else {
        s_obj = PyLong_FromSsize_t(E->next_slot);
        if (!s_obj) {
            Py_DECREF(i_obj);
            return -1;
        }
        E->next_slot++;
        if (E->next_slot > E->n_slots) E->n_slots = E->next_slot;
    }
    if (PyDict_SetItem(E->open_bp, p, s_obj) < 0) goto inverr;
    /* encode args (intern order: u then w, like the twin) */
    {
        PyObject *aobj, *bobj;
        if (fcode == 2) {
            PyObject *u = PySequence_Fast_GET_ITEM(v, 0);
            PyObject *w = PySequence_Fast_GET_ITEM(v, 1);
            aobj = intern_id_c(E->ids, E->table, u, 0);
            if (!aobj) goto inverr;
            bobj = intern_id_c(E->ids, E->table, w, 0);
            if (!bobj) {
                Py_DECREF(aobj);
                goto inverr;
            }
        } else {
            aobj = intern_id_c(E->ids, E->table, v, 0);
            if (!aobj) goto inverr;
            bobj = g_int[0];
            Py_INCREF(bobj);
        }
        int rc = 0;
        if (PyList_Append(E->kindl, g_int[0]) < 0 || /* EV_INVOKE */
            PyList_Append(E->slotl, s_obj) < 0 ||
            PyList_Append(E->fl, g_int[fcode]) < 0 ||
            PyList_Append(E->al, aobj) < 0 ||
            PyList_Append(E->bl, bobj) < 0 ||
            PyList_Append(E->oil, i_obj) < 0)
            rc = -1;
        Py_DECREF(aobj);
        Py_DECREF(bobj);
        if (rc < 0) goto inverr;
    }
    Py_DECREF(s_obj);
    Py_DECREF(i_obj);
    return 0;
inverr:
    Py_DECREF(s_obj);
    Py_DECREF(i_obj);
    return -1;
}

/* Completion ("ok") op at enc_ops index i. 0 advance, -1 error. */
static int enc_step_ok(encst *E, PyObject *p, Py_ssize_t i) {
    PyObject *s_obj = dict_pop(E->open_bp, p);
    if (!s_obj && PyErr_Occurred()) return -1;
    if (s_obj) {
        PyObject *i_obj = PyLong_FromSsize_t(i);
        if (!i_obj) {
            Py_DECREF(s_obj);
            return -1;
        }
        int rc = 0;
        if (PyList_Append(E->kindl, g_int[1]) < 0 || /* EV_RETURN */
            PyList_Append(E->slotl, s_obj) < 0 ||
            PyList_Append(E->fl, g_int[0]) < 0 ||
            PyList_Append(E->al, g_int[0]) < 0 ||
            PyList_Append(E->bl, g_int[0]) < 0 ||
            PyList_Append(E->oil, i_obj) < 0 ||
            PyList_Append(E->free_slots, s_obj) < 0)
            rc = -1;
        Py_DECREF(i_obj);
        Py_DECREF(s_obj);
        if (rc < 0) return -1;
    }
    return 0;
}

/* register_encode(state) -> (next, next_slot, n_slots, bailed)
 * state = (_ops, outcome, open_by_process, free_slots,
 *          kind, slot, f, a, b, op_index,
 *          intern_ids, intern_table, next, next_slot, n_slots,
 *          finalized)
 * On bail the returned cursor points AT the offending op with no
 * mutations for it; the wrapper re-runs the Python twin from there. */
static PyObject *register_encode(PyObject *self, PyObject *args) {
    (void)self;
    PyObject *st;
    if (!PyArg_ParseTuple(args, "O!", &PyTuple_Type, &st)) return NULL;
    if (PyTuple_GET_SIZE(st) != 16) {
        PyErr_SetString(PyExc_ValueError, "encode state tuple != 16");
        return NULL;
    }
    PyObject *enc_ops = PyTuple_GET_ITEM(st, 0);
    PyObject *outcome = PyTuple_GET_ITEM(st, 1);
    PyObject *open_bp = PyTuple_GET_ITEM(st, 2);
    PyObject *free_slots = PyTuple_GET_ITEM(st, 3);
    PyObject *kindl = PyTuple_GET_ITEM(st, 4);
    PyObject *slotl = PyTuple_GET_ITEM(st, 5);
    PyObject *fl = PyTuple_GET_ITEM(st, 6);
    PyObject *al = PyTuple_GET_ITEM(st, 7);
    PyObject *bl = PyTuple_GET_ITEM(st, 8);
    PyObject *oil = PyTuple_GET_ITEM(st, 9);
    PyObject *ids = PyTuple_GET_ITEM(st, 10);
    PyObject *table = PyTuple_GET_ITEM(st, 11);
    Py_ssize_t i = PyLong_AsSsize_t(PyTuple_GET_ITEM(st, 12));
    Py_ssize_t next_slot = PyLong_AsSsize_t(PyTuple_GET_ITEM(st, 13));
    Py_ssize_t n_slots = PyLong_AsSsize_t(PyTuple_GET_ITEM(st, 14));
    int finalized = PyObject_IsTrue(PyTuple_GET_ITEM(st, 15));
    if (PyErr_Occurred()) return NULL;
    if (!PyList_CheckExact(enc_ops) || !PyDict_CheckExact(outcome) ||
        !PyDict_CheckExact(open_bp) || !PyList_CheckExact(free_slots) ||
        !PyList_CheckExact(kindl) || !PyList_CheckExact(slotl) ||
        !PyList_CheckExact(fl) || !PyList_CheckExact(al) ||
        !PyList_CheckExact(bl) || !PyList_CheckExact(oil) ||
        !PyDict_CheckExact(ids) || !PyList_CheckExact(table)) {
        PyErr_SetString(PyExc_TypeError, "encode state shape");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(enc_ops);
    int bailed = 0;
    encst E = {outcome, open_bp, free_slots, kindl, slotl, fl, al, bl,
               oil, ids, table, next_slot, n_slots, finalized};
    while (i < n) {
        PyObject *op = PyList_GET_ITEM(enc_ops, i);
        if (!PyDict_CheckExact(op)) {
            bailed = 1;
            break;
        }
        PyObject *p = PyDict_GetItemWithError(op, g_s_process);
        if (!p && PyErr_Occurred()) return NULL;
        if (!proc_ok(p)) {
            i++;
            continue;
        }
        PyObject *typ = PyDict_GetItemWithError(op, g_s_type);
        if (!typ && PyErr_Occurred()) return NULL;
        if (!typ || !PyUnicode_CheckExact(typ)) {
            i++;
            continue;
        }
        if (PyUnicode_CompareWithASCIIString(typ, "invoke") == 0) {
            int rc = enc_step_invoke(&E, op, p, i, NULL, 0);
            if (rc < 0) return NULL;
            if (rc == 1) break; /* stall */
            if (rc == 2) {
                bailed = 1;
                break;
            }
            i++;
            continue;
        }
        if (PyUnicode_CompareWithASCIIString(typ, "ok") == 0) {
            if (enc_step_ok(&E, p, i) < 0) return NULL;
        }
        i++;
    }
    return Py_BuildValue("(nnni)", i, E.next_slot, E.n_slots, bailed);
}

/* Per-op field cache filled by the fused add pass and consumed by its
 * encode pass, so each chunk dict is classified once. typec: 0 invoke,
 * 1 ok, 2 fail, 3 info, 4 no-encode-action. outc mirrors outcome[i]
 * writes made during THIS call (borrowed from the outcome dict, which
 * outlives the call); NULL = unresolved, authoritative for indices
 * appended by this call since older calls could not have resolved
 * ops that did not exist yet. */
typedef struct {
    PyObject *proc; /* borrowed from the op dict */
    PyObject *outc; /* borrowed from the outcome dict */
    int8_t typec;
} opmeta;

/* register_add_encode(ops, start, add_state, enc_state)
 * -> (next, next_slot, n_slots, enc_ran, bailed)
 * One pass over the chunk: LiveRegisterEncoder.add bookkeeping with
 * the per-op classification cached, then encode_resolved consuming
 * the cache — the chunk's dicts are inspected once instead of twice.
 * The encode phase is skipped (enc_ran=0) when the chunk held non-
 * dict ops (py_add may append extra entries, shifting indices); the
 * caller's next encode_resolved covers it from identical state. */
static PyObject *register_add_encode(PyObject *self, PyObject *args) {
    (void)self;
    PyObject *ops, *ast, *est;
    Py_ssize_t start;
    if (!PyArg_ParseTuple(args, "O!nO!O!", &PyList_Type, &ops, &start,
                          &PyTuple_Type, &ast, &PyTuple_Type, &est))
        return NULL;
    if (PyTuple_GET_SIZE(ast) != 4 || PyTuple_GET_SIZE(est) != 16) {
        PyErr_SetString(PyExc_ValueError, "add/encode state tuple size");
        return NULL;
    }
    PyObject *enc_ops = PyTuple_GET_ITEM(ast, 0);
    PyObject *open_inv = PyTuple_GET_ITEM(ast, 1);
    PyObject *outcome = PyTuple_GET_ITEM(ast, 2);
    PyObject *py_add = PyTuple_GET_ITEM(ast, 3);
    PyObject *open_bp = PyTuple_GET_ITEM(est, 2);
    PyObject *free_slots = PyTuple_GET_ITEM(est, 3);
    PyObject *kindl = PyTuple_GET_ITEM(est, 4);
    PyObject *slotl = PyTuple_GET_ITEM(est, 5);
    PyObject *fl = PyTuple_GET_ITEM(est, 6);
    PyObject *al = PyTuple_GET_ITEM(est, 7);
    PyObject *bl = PyTuple_GET_ITEM(est, 8);
    PyObject *oil = PyTuple_GET_ITEM(est, 9);
    PyObject *ids = PyTuple_GET_ITEM(est, 10);
    PyObject *table = PyTuple_GET_ITEM(est, 11);
    Py_ssize_t next = PyLong_AsSsize_t(PyTuple_GET_ITEM(est, 12));
    Py_ssize_t next_slot = PyLong_AsSsize_t(PyTuple_GET_ITEM(est, 13));
    Py_ssize_t n_slots = PyLong_AsSsize_t(PyTuple_GET_ITEM(est, 14));
    int finalized = PyObject_IsTrue(PyTuple_GET_ITEM(est, 15));
    if (PyErr_Occurred()) return NULL;
    if (PyTuple_GET_ITEM(est, 0) != enc_ops ||
        PyTuple_GET_ITEM(est, 1) != outcome ||
        !PyList_CheckExact(enc_ops) || !PyDict_CheckExact(open_inv) ||
        !PyDict_CheckExact(outcome) || !PyDict_CheckExact(open_bp) ||
        !PyList_CheckExact(free_slots) || !PyList_CheckExact(kindl) ||
        !PyList_CheckExact(slotl) || !PyList_CheckExact(fl) ||
        !PyList_CheckExact(al) || !PyList_CheckExact(bl) ||
        !PyList_CheckExact(oil) || !PyDict_CheckExact(ids) ||
        !PyList_CheckExact(table)) {
        PyErr_SetString(PyExc_TypeError, "add/encode state shape");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(ops);
    Py_ssize_t base = PyList_GET_SIZE(enc_ops);
    Py_ssize_t ncache = n > start ? n - start : 0;
    opmeta *meta = NULL;
    int enc_ok = 1;
    if (ncache) {
        meta = (opmeta *)calloc((size_t)ncache, sizeof(opmeta));
        if (!meta) return PyErr_NoMemory();
    }
    /* ---- add pass (twin of LiveRegisterEncoder.add, plus the cache
     * fill) ---- */
    for (Py_ssize_t k = start; k < n; k++) {
        PyObject *op = PyList_GET_ITEM(ops, k);
        if (!PyDict_CheckExact(op)) {
            enc_ok = 0; /* py_add appends itself; indices shift */
            PyObject *r = PyObject_CallFunctionObjArgs(py_add, op, NULL);
            if (!r) goto adderr;
            Py_DECREF(r);
            continue;
        }
        Py_ssize_t i = PyList_GET_SIZE(enc_ops);
        if (PyList_Append(enc_ops, op) < 0) goto adderr;
        opmeta *mt = NULL;
        if (enc_ok && i >= base && i - base < ncache)
            mt = &meta[i - base];
        else
            enc_ok = 0;
        if (mt) mt->typec = 4;
        PyObject *p = PyDict_GetItemWithError(op, g_s_process);
        if (!p && PyErr_Occurred()) goto adderr;
        if (!proc_ok(p)) continue;
        PyObject *typ = PyDict_GetItemWithError(op, g_s_type);
        if (!typ && PyErr_Occurred()) goto adderr;
        if (!typ || !PyUnicode_CheckExact(typ)) continue;
        PyObject *j = NULL;
        if (PyUnicode_CompareWithASCIIString(typ, "invoke") == 0) {
            if (mt) {
                mt->typec = 0;
                mt->proc = p;
            }
            j = dict_pop(open_inv, p);
            if (!j && PyErr_Occurred()) goto adderr;
            if (j) { /* same process re-invokes: prior op resolves keep */
                if (PyDict_SetItem(outcome, j, g_keep) < 0) {
                    Py_DECREF(j);
                    goto adderr;
                }
                Py_ssize_t jv = PyLong_AsSsize_t(j);
                Py_DECREF(j);
                if (jv == -1 && PyErr_Occurred()) goto adderr;
                if (jv >= base && jv - base < ncache)
                    meta[jv - base].outc = g_keep;
            }
            PyObject *i_obj = PyLong_FromSsize_t(i);
            if (!i_obj) goto adderr;
            int rc = PyDict_SetItem(open_inv, p, i_obj);
            Py_DECREF(i_obj);
            if (rc < 0) goto adderr;
        } else if (PyUnicode_CompareWithASCIIString(typ, "ok") == 0) {
            if (mt) {
                mt->typec = 1;
                mt->proc = p;
            }
            j = dict_pop(open_inv, p);
            if (!j && PyErr_Occurred()) goto adderr;
            if (j) {
                PyObject *v = PyDict_GetItemWithError(op, g_s_value);
                if (!v && PyErr_Occurred()) {
                    Py_DECREF(j);
                    goto adderr;
                }
                PyObject *out;
                if (v && v != Py_None) {
                    out = PyTuple_Pack(2, g_s_ok, v);
                    if (!out) {
                        Py_DECREF(j);
                        goto adderr;
                    }
                } else {
                    out = g_keep;
                    Py_INCREF(out);
                }
                int rc = PyDict_SetItem(outcome, j, out);
                Py_ssize_t jv = PyLong_AsSsize_t(j);
                Py_DECREF(j);
                if (rc < 0 || (jv == -1 && PyErr_Occurred())) {
                    Py_DECREF(out);
                    goto adderr;
                }
                if (jv >= base && jv - base < ncache)
                    meta[jv - base].outc = out; /* dict keeps it alive */
                Py_DECREF(out);
            }
        } else if (PyUnicode_CompareWithASCIIString(typ, "fail") == 0) {
            if (mt) mt->typec = 2;
            j = dict_pop(open_inv, p);
            if (!j && PyErr_Occurred()) goto adderr;
            if (j) {
                int rc = PyDict_SetItem(outcome, j, g_drop);
                Py_ssize_t jv = PyLong_AsSsize_t(j);
                Py_DECREF(j);
                if (rc < 0 || (jv == -1 && PyErr_Occurred()))
                    goto adderr;
                if (jv >= base && jv - base < ncache)
                    meta[jv - base].outc = g_drop;
            }
        } else if (PyUnicode_CompareWithASCIIString(typ, "info") == 0) {
            if (mt) mt->typec = 3;
            j = dict_pop(open_inv, p);
            if (!j && PyErr_Occurred()) goto adderr;
            if (j) {
                Py_ssize_t ji = PyLong_AsSsize_t(j);
                if (ji == -1 && PyErr_Occurred()) {
                    Py_DECREF(j);
                    goto adderr;
                }
                PyObject *inv = (ji >= 0 && ji < PyList_GET_SIZE(enc_ops))
                                    ? PyList_GET_ITEM(enc_ops, ji)
                                    : NULL;
                if (!inv || !PyDict_CheckExact(inv)) {
                    Py_DECREF(j);
                    PyErr_SetString(PyExc_AttributeError,
                                    "invocation is not a dict");
                    goto adderr;
                }
                PyObject *fj = PyDict_GetItemWithError(inv, g_s_f);
                if (!fj && PyErr_Occurred()) {
                    Py_DECREF(j);
                    goto adderr;
                }
                int rd = PyObject_RichCompareBool(fj ? fj : Py_None,
                                                  g_s_read, Py_EQ);
                if (rd < 0) {
                    Py_DECREF(j);
                    goto adderr;
                }
                int rc = PyDict_SetItem(outcome, j, rd ? g_drop : g_keep);
                Py_DECREF(j);
                if (rc < 0) goto adderr;
                if (ji >= base && ji - base < ncache)
                    meta[ji - base].outc = rd ? g_drop : g_keep;
            }
        }
    }
    /* ---- encode pass (twin of register_encode over the cache) ---- */
    {
        int bailed = 0;
        int enc_ran = enc_ok;
        Py_ssize_t i = next;
        if (enc_ok) {
            encst E = {outcome, open_bp, free_slots, kindl, slotl, fl,
                       al, bl, oil, ids, table, next_slot, n_slots,
                       finalized};
            Py_ssize_t ne = PyList_GET_SIZE(enc_ops);
            while (i < ne) {
                PyObject *op = PyList_GET_ITEM(enc_ops, i);
                if (!PyDict_CheckExact(op)) {
                    bailed = 1;
                    break;
                }
                int8_t tc;
                PyObject *p;
                PyObject *outc = NULL;
                int have = 0;
                if (i >= base && i - base < ncache) {
                    opmeta *mt = &meta[i - base];
                    tc = mt->typec;
                    p = mt->proc;
                    outc = mt->outc;
                    have = 1;
                } else { /* stalled op from an earlier chunk */
                    p = PyDict_GetItemWithError(op, g_s_process);
                    if (!p && PyErr_Occurred()) goto adderr;
                    if (!proc_ok(p)) {
                        i++;
                        continue;
                    }
                    PyObject *typ =
                        PyDict_GetItemWithError(op, g_s_type);
                    if (!typ && PyErr_Occurred()) goto adderr;
                    if (!typ || !PyUnicode_CheckExact(typ)) {
                        i++;
                        continue;
                    }
                    if (PyUnicode_CompareWithASCIIString(typ, "invoke") ==
                        0)
                        tc = 0;
                    else if (PyUnicode_CompareWithASCIIString(typ,
                                                              "ok") == 0)
                        tc = 1;
                    else
                        tc = 4;
                }
                if (tc == 0) {
                    int rc = enc_step_invoke(&E, op, p, i, outc, have);
                    if (rc < 0) goto adderr;
                    if (rc == 1) break; /* stall */
                    if (rc == 2) {
                        bailed = 1;
                        break;
                    }
                } else if (tc == 1) {
                    if (enc_step_ok(&E, p, i) < 0) goto adderr;
                }
                i++;
            }
            next_slot = E.next_slot;
            n_slots = E.n_slots;
        }
        free(meta);
        return Py_BuildValue("(nnnii)", i, next_slot, n_slots, enc_ran,
                             bailed);
    }
adderr:
    free(meta);
    return NULL;
}


/* copied from jepsen_tpu/native/columnar_ext.c:2246-2824 */
/* -------------------- frontier absorb --------------------------------
 * Twin of checker/linear_cpu.FrontierSession.absorb for the hardcoded
 * cas-register step. Works entirely on copies: on success returns
 * replacement state, on bail/death returns a signal and the caller
 * replays the Python twin against the UNTOUCHED session (identical
 * result()/failure payloads). */

typedef struct {
    uint64_t *keys;   /* (mask << 1) | 1 sentinel-free packing unused; */
    int64_t *states;  /* parallel value array */
    uint8_t *used;
    size_t cap, n;
} cfgset;

static int cfg_init(cfgset *h, size_t cap) {
    h->cap = cap;
    h->n = 0;
    h->keys = (uint64_t *)calloc(cap, 8);
    h->states = (int64_t *)malloc(cap * 8);
    h->used = (uint8_t *)calloc(cap, 1);
    if (!h->keys || !h->states || !h->used) return -1;
    return 0;
}

static void cfg_free(cfgset *h) {
    free(h->keys);
    free(h->states);
    free(h->used);
}

static int cfg_insert(cfgset **hp, uint64_t mask, int64_t state);

static int cfg_grow(cfgset **hp) {
    cfgset *h = *hp;
    cfgset *nh = (cfgset *)malloc(sizeof(cfgset));
    if (!nh) return -1;
    if (cfg_init(nh, h->cap * 2) < 0) {
        cfg_free(nh);
        free(nh);
        return -1;
    }
    for (size_t i = 0; i < h->cap; i++)
        if (h->used[i])
            if (cfg_insert(&nh, h->keys[i], h->states[i]) < 0) {
                cfg_free(nh);
                free(nh);
                return -1;
            }
    cfg_free(h);
    free(h);
    *hp = nh;
    return 0;
}

/* returns 1 inserted, 0 already present, -1 oom */
static int cfg_insert(cfgset **hp, uint64_t mask, int64_t state) {
    cfgset *h = *hp;
    if ((h->n + 1) * 10 >= h->cap * 7) {
        if (cfg_grow(hp) < 0) return -1;
        h = *hp;
    }
    uint64_t hash = (mask * 0x9E3779B97F4A7C15ULL) ^
                    ((uint64_t)state * 0xC2B2AE3D27D4EB4FULL);
    size_t idx = (size_t)hash & (h->cap - 1);
    for (;;) {
        if (!h->used[idx]) {
            h->used[idx] = 1;
            h->keys[idx] = mask;
            h->states[idx] = state;
            h->n++;
            return 1;
        }
        if (h->keys[idx] == mask && h->states[idx] == state) return 0;
        idx = (idx + 1) & (h->cap - 1);
    }
}

#define FRONTIER_CFG_CAP (1 << 20)

static int list_i64(PyObject *l, Py_ssize_t i, int64_t *out) {
    PyObject *o = PyList_GET_ITEM(l, i);
    if (!PyLong_CheckExact(o)) return -1;
    int ovf = 0;
    long long v = PyLong_AsLongLongAndOverflow(o, &ovf);
    if (ovf || (v == -1 && PyErr_Occurred())) {
        PyErr_Clear();
        return -1;
    }
    *out = v;
    return 0;
}

/* frontier_absorb(configs, cur, cur_idx, pending_mask,
 *                 kind, slot, f, a, b, op_index, start, end,
 *                 configs_max)
 * -> None                              regime miss: Python twin
 *  | ("dead", event_index)            death: Python twin for forensics
 *  | (configs', cur', cur_idx', pending_mask', configs_max', seen_max) */
static PyObject *frontier_absorb(PyObject *self, PyObject *args) {
    (void)self;
    PyObject *configs, *cur, *cur_idx;
    long long pending_in;
    PyObject *kindl, *slotl, *fl, *al, *bl, *oil;
    Py_ssize_t start, end;
    long long configs_max_in;
    if (!PyArg_ParseTuple(args, "O!O!O!LO!O!O!O!O!O!nnL", &PySet_Type,
                          &configs, &PyDict_Type, &cur, &PyDict_Type,
                          &cur_idx, &pending_in, &PyList_Type, &kindl,
                          &PyList_Type, &slotl, &PyList_Type, &fl,
                          &PyList_Type, &al, &PyList_Type, &bl,
                          &PyList_Type, &oil, &start, &end,
                          &configs_max_in))
        return NULL;
    if (pending_in < 0) Py_RETURN_NONE;
    uint64_t pending = (uint64_t)pending_in;
    int64_t configs_max = configs_max_in;

    /* mirror the session's per-slot current-invocation table */
    int64_t curf[63], cura[63], curb[63], curidx[63];
    uint64_t occ = 0;

    /* load cur: {slot: (f, a, b)} */
    {
        PyObject *k, *v;
        Py_ssize_t ppos = 0;
        while (PyDict_Next(cur, &ppos, &k, &v)) {
            if (!PyLong_CheckExact(k) || !PyTuple_CheckExact(v) ||
                PyTuple_GET_SIZE(v) != 3)
                Py_RETURN_NONE;
            long sl = PyLong_AsLong(k);
            if (sl < 0 || sl >= 63) {
                PyErr_Clear();
                Py_RETURN_NONE;
            }
            int64_t fv, av, bv;
            PyObject *t0 = PyTuple_GET_ITEM(v, 0);
            PyObject *t1 = PyTuple_GET_ITEM(v, 1);
            PyObject *t2 = PyTuple_GET_ITEM(v, 2);
            if (as_i64(t0, &fv) || as_i64(t1, &av) || as_i64(t2, &bv))
                Py_RETURN_NONE;
            curf[sl] = fv;
            cura[sl] = av;
            curb[sl] = bv;
            curidx[sl] = -1;
            occ |= 1ULL << sl;
        }
        ppos = 0;
        while (PyDict_Next(cur_idx, &ppos, &k, &v)) {
            if (!PyLong_CheckExact(k)) Py_RETURN_NONE;
            long sl = PyLong_AsLong(k);
            if (sl < 0 || sl >= 63 || !(occ & (1ULL << sl))) {
                PyErr_Clear();
                Py_RETURN_NONE;
            }
            int64_t iv;
            if (as_i64(v, &iv)) Py_RETURN_NONE;
            curidx[sl] = iv;
        }
    }

    /* load configs into a flat frontier array */
    size_t ncfg = (size_t)PySet_GET_SIZE(configs);
    size_t fcap = ncfg ? ncfg : 1;
    uint64_t *fmask = (uint64_t *)malloc(fcap * 8);
    int64_t *fstate = (int64_t *)malloc(fcap * 8);
    size_t fn = 0;
    uint64_t *nmask = NULL;
    int64_t *nstate = NULL;
    size_t ncap = 0;
    cfgset *seen = NULL;
    PyObject *it = NULL;
    int64_t seen_max = 0;
    if (!fmask || !fstate) goto oom;
    it = PyObject_GetIter(configs);
    if (!it) goto err;
    {
        PyObject *item;
        while ((item = PyIter_Next(it)) != NULL) {
            int64_t mv, sv;
            if (!PyTuple_CheckExact(item) || PyTuple_GET_SIZE(item) != 2 ||
                as_i64(PyTuple_GET_ITEM(item, 0), &mv) ||
                as_i64(PyTuple_GET_ITEM(item, 1), &sv) || mv < 0) {
                Py_DECREF(item);
                goto bail;
            }
            fmask[fn] = (uint64_t)mv;
            fstate[fn] = sv;
            fn++;
            Py_DECREF(item);
        }
        if (PyErr_Occurred()) goto err;
    }
    Py_CLEAR(it);

    {
        Py_ssize_t nev = PyList_GET_SIZE(kindl);
        if (end > nev || PyList_GET_SIZE(slotl) < end ||
            PyList_GET_SIZE(fl) < end || PyList_GET_SIZE(al) < end ||
            PyList_GET_SIZE(bl) < end || PyList_GET_SIZE(oil) < end)
            goto bail;
    }

    for (Py_ssize_t e = start; e < end; e++) {
        int64_t kv, sv;
        if (list_i64(kindl, e, &kv) || list_i64(slotl, e, &sv)) goto bail;
        if (kv == 2) continue; /* EV_NOOP */
        if (sv < 0 || sv >= 63) goto bail;
        int sl = (int)sv;
        if (kv == 0) { /* EV_INVOKE */
            int64_t fv, av, bv, iv;
            if (list_i64(fl, e, &fv) || list_i64(al, e, &av) ||
                list_i64(bl, e, &bv) || list_i64(oil, e, &iv))
                goto bail;
            curf[sl] = fv;
            cura[sl] = av;
            curb[sl] = bv;
            curidx[sl] = iv;
            occ |= 1ULL << sl;
            pending |= 1ULL << sl;
            continue;
        }
        if (kv != 1) goto bail; /* EV_RETURN */
        uint64_t bit = 1ULL << sl;
        if (fn == 1 && (pending & ~fmask[0]) == bit) {
            /* singleton frontier with only this return's op available —
             * the steady state of a narrow live stream. The twin's
             * closure is exactly {cfg0, cfg0+op}: survival means the op
             * fires and succeeds, and the sole surviving config keeps
             * mask0 (the op's bit is set by the closure and cleared by
             * the filter) with the stepped state. */
            int64_t fv = curf[sl], av = cura[sl], bv = curb[sl];
            int64_t st = fstate[0], st2 = st;
            int okv;
            if (fv == 0) { /* read */
                okv = (av == 0 || av == st);
            } else if (fv == 1) { /* write */
                st2 = av;
                okv = 1;
            } else if (fv == 2) { /* cas */
                if (st == av) {
                    st2 = bv;
                    okv = 1;
                } else {
                    okv = 0;
                }
            } else {
                okv = 0;
            }
            if (!okv) { /* nothing fired: death, replay in Python */
                PyObject *r = Py_BuildValue("(sn)", "dead", e);
                free(fmask);
                free(fstate);
                free(nmask);
                free(nstate);
                if (seen) {
                    cfg_free(seen);
                    free(seen);
                }
                return r;
            }
            fstate[0] = st2;
            /* all_seen was {cfg0, cfg0+op}: two distinct masks */
            if (configs_max < 2) configs_max = 2;
            if (seen_max < 2) seen_max = 2;
            pending &= ~bit;
            continue;
        }
        /* small frontier: the BFS closure fits in fixed arrays with
         * linear-scan dedup, skipping the hashtable's reset/insert
         * machinery entirely. Narrow live streams (concurrency <= ~5)
         * spend almost every return here. Overflow falls through to
         * the general path with the frontier untouched. */
        if (fn <= 6) {
            uint64_t sm[96];
            int64_t ss[96];
            size_t sn = fn, qh = 0;
            int overflow = 0;
            memcpy(sm, fmask, fn * 8);
            memcpy(ss, fstate, fn * 8);
            while (qh < sn && !overflow) {
                uint64_t mask = sm[qh];
                int64_t state = ss[qh];
                qh++;
                uint64_t avail = pending & ~mask;
                while (avail) {
                    int b2 = __builtin_ctzll(avail);
                    uint64_t abit = 1ULL << b2;
                    avail &= avail - 1;
                    int64_t fv = curf[b2], av = cura[b2], bv = curb[b2];
                    int64_t st2 = state;
                    int okv;
                    if (fv == 0) {
                        okv = (av == 0 || av == state);
                    } else if (fv == 1) {
                        st2 = av;
                        okv = 1;
                    } else if (fv == 2) {
                        if (state == av) {
                            st2 = bv;
                            okv = 1;
                        } else {
                            okv = 0;
                        }
                    } else {
                        okv = 0;
                    }
                    if (!okv) continue;
                    uint64_t nm = mask | abit;
                    size_t si;
                    for (si = 0; si < sn; si++)
                        if (sm[si] == nm && ss[si] == st2) break;
                    if (si < sn) continue;
                    if (sn == 96) {
                        overflow = 1;
                        break;
                    }
                    sm[sn] = nm;
                    ss[sn] = st2;
                    sn++;
                }
            }
            if (!overflow) {
                if (configs_max < (int64_t)sn) configs_max = sn;
                if (seen_max < (int64_t)sn) seen_max = sn;
                /* keep configs where this return fired; clear its bit
                 * and dedup (the twin's set comprehension) */
                uint64_t om[96];
                int64_t os[96];
                size_t nn = 0;
                for (size_t si = 0; si < sn; si++) {
                    if (!(sm[si] & bit)) continue;
                    uint64_t nm = sm[si] & ~bit;
                    size_t di;
                    for (di = 0; di < nn; di++)
                        if (om[di] == nm && os[di] == ss[si]) break;
                    if (di < nn) continue;
                    om[nn] = nm;
                    os[nn] = ss[si];
                    nn++;
                }
                if (nn == 0) { /* death: replay in Python */
                    PyObject *r = Py_BuildValue("(sn)", "dead", e);
                    free(fmask);
                    free(fstate);
                    free(nmask);
                    free(nstate);
                    if (seen) {
                        cfg_free(seen);
                        free(seen);
                    }
                    return r;
                }
                if (nn > fcap) {
                    size_t nc = fcap;
                    while (nc < nn) nc *= 2;
                    uint64_t *m2 = (uint64_t *)realloc(fmask, nc * 8);
                    if (!m2) goto oom;
                    fmask = m2;
                    int64_t *s2 = (int64_t *)realloc(fstate, nc * 8);
                    if (!s2) goto oom;
                    fstate = s2;
                    fcap = nc;
                }
                memcpy(fmask, om, nn * 8);
                memcpy(fstate, os, nn * 8);
                fn = nn;
                pending &= ~bit;
                continue;
            }
        }
        /* BFS closure over pending subsets, then require `bit` fired */
        if (!seen) {
            seen = (cfgset *)malloc(sizeof(cfgset));
            if (!seen) goto oom;
            if (cfg_init(seen, 256) < 0) goto oom;
        } else {
            /* reset in place */
            memset(seen->used, 0, seen->cap);
            seen->n = 0;
        }
        for (size_t ci = 0; ci < fn; ci++)
            if (cfg_insert(&seen, fmask[ci], fstate[ci]) < 0) goto oom;
        /* frontier arrays double as the BFS work queue */
        size_t qhead = 0, qtail = fn, qcap = fcap;
        uint64_t *qmask = fmask;
        int64_t *qstate = fstate;
        while (qhead < qtail) {
            uint64_t mask = qmask[qhead];
            int64_t state = qstate[qhead];
            qhead++;
            uint64_t avail = pending & ~mask;
            while (avail) {
                int b2 = __builtin_ctzll(avail);
                uint64_t abit = 1ULL << b2;
                avail &= avail - 1;
                int64_t fv = curf[b2], av = cura[b2], bv = curb[b2];
                int64_t st2 = state;
                int okv;
                if (fv == 0) { /* read */
                    okv = (av == 0 || av == state);
                } else if (fv == 1) { /* write */
                    st2 = av;
                    okv = 1;
                } else if (fv == 2) { /* cas */
                    if (state == av) {
                        st2 = bv;
                        okv = 1;
                    } else {
                        okv = 0;
                    }
                } else {
                    okv = 0;
                }
                if (!okv) continue;
                int ins = cfg_insert(&seen, mask | abit, st2);
                if (ins < 0) goto oom;
                if (ins) {
                    if ((int64_t)seen->n > FRONTIER_CFG_CAP) goto bail;
                    if (qtail == qcap) {
                        size_t nc = qcap * 2;
                        uint64_t *m2 =
                            (uint64_t *)realloc(qmask, nc * 8);
                        if (!m2) goto oom;
                        qmask = m2;
                        int64_t *s2 =
                            (int64_t *)realloc(qstate, nc * 8);
                        if (!s2) goto oom;
                        qstate = s2;
                        qcap = nc;
                    }
                    qmask[qtail] = mask | abit;
                    qstate[qtail] = st2;
                    qtail++;
                }
            }
        }
        fmask = qmask;
        fstate = qstate;
        fcap = qcap;
        if ((int64_t)seen->n > configs_max) configs_max = seen->n;
        if ((int64_t)seen->n > seen_max) seen_max = seen->n;
        /* keep only configs where this return's op fired; clear its bit */
        if (ncap < seen->n) {
            free(nmask);
            free(nstate);
            ncap = seen->n ? seen->n : 1;
            nmask = (uint64_t *)malloc(ncap * 8);
            nstate = (int64_t *)malloc(ncap * 8);
            if (!nmask || !nstate) goto oom;
        }
        size_t nn = 0;
        for (size_t si = 0; si < seen->cap; si++) {
            if (!seen->used[si] || !(seen->keys[si] & bit)) continue;
            nmask[nn] = seen->keys[si] & ~bit;
            nstate[nn] = seen->states[si];
            nn++;
        }
        /* dedup after clearing the bit (the twin's set comprehension) */
        memset(seen->used, 0, seen->cap);
        seen->n = 0;
        fn = 0;
        for (size_t si = 0; si < nn; si++) {
            int ins = cfg_insert(&seen, nmask[si], nstate[si]);
            if (ins < 0) goto oom;
            if (ins) {
                if (fn == fcap) {
                    size_t nc = fcap * 2;
                    uint64_t *m2 = (uint64_t *)realloc(fmask, nc * 8);
                    if (!m2) goto oom;
                    fmask = m2;
                    int64_t *s2 = (int64_t *)realloc(fstate, nc * 8);
                    if (!s2) goto oom;
                    fstate = s2;
                    fcap = nc;
                }
                fmask[fn] = nmask[si];
                fstate[fn] = nstate[si];
                fn++;
            }
        }
        pending &= ~bit;
        if (fn == 0) { /* death: replay in Python for the forensics */
            PyObject *r = Py_BuildValue("(sn)", "dead", e);
            free(fmask);
            free(fstate);
            free(nmask);
            free(nstate);
            cfg_free(seen);
            free(seen);
            return r;
        }
    }

    /* success: build replacement Python state */
    {
        PyObject *cfg_out = PySet_New(NULL);
        PyObject *cur_out = PyDict_New();
        PyObject *ci_out = PyDict_New();
        PyObject *res = NULL;
        if (!cfg_out || !cur_out || !ci_out) goto werr;
        for (size_t si = 0; si < fn; si++) {
            PyObject *t = Py_BuildValue("(LL)", (long long)fmask[si],
                                        (long long)fstate[si]);
            if (!t || PySet_Add(cfg_out, t) < 0) {
                Py_XDECREF(t);
                goto werr;
            }
            Py_DECREF(t);
        }
        for (int sl = 0; sl < 63; sl++) {
            if (!(occ & (1ULL << sl))) continue;
            PyObject *k = PyLong_FromLong(sl);
            PyObject *v = Py_BuildValue("(LLL)", (long long)curf[sl],
                                        (long long)cura[sl],
                                        (long long)curb[sl]);
            if (!k || !v || PyDict_SetItem(cur_out, k, v) < 0) {
                Py_XDECREF(k);
                Py_XDECREF(v);
                goto werr;
            }
            Py_DECREF(v);
            if (curidx[sl] >= 0) {
                PyObject *iv = PyLong_FromLongLong(curidx[sl]);
                if (!iv || PyDict_SetItem(ci_out, k, iv) < 0) {
                    Py_XDECREF(iv);
                    Py_DECREF(k);
                    goto werr;
                }
                Py_DECREF(iv);
            }
            Py_DECREF(k);
        }
        res = Py_BuildValue("(NNNLLL)", cfg_out, cur_out, ci_out,
                            (long long)pending, (long long)configs_max,
                            (long long)seen_max);
        if (!res) goto werr2;
        free(fmask);
        free(fstate);
        free(nmask);
        free(nstate);
        if (seen) {
            cfg_free(seen);
            free(seen);
        }
        return res;
    werr:
        Py_XDECREF(cfg_out);
        Py_XDECREF(cur_out);
        Py_XDECREF(ci_out);
    werr2:
        goto err;
    }

bail:
    free(fmask);
    free(fstate);
    free(nmask);
    free(nstate);
    if (seen) {
        cfg_free(seen);
        free(seen);
    }
    Py_XDECREF(it);
    if (PyErr_Occurred()) PyErr_Clear();
    Py_RETURN_NONE;
oom:
    if (!PyErr_Occurred()) PyErr_NoMemory();
err:
    free(fmask);
    free(fstate);
    free(nmask);
    free(nstate);
    if (seen) {
        cfg_free(seen);
        free(seen);
    }
    Py_XDECREF(it);
    return NULL;
}
/* copied from jepsen_tpu/native/columnar_ext.c:3206-3227, without
 * builder_extend and sim_lane */
/* The spine entry points allocate container objects (op dicts, value
   lists, column ints) at millions per second; CPython's generational
   collector walking gen0 every ~700 allocations costs about half the
   parse throughput on register-op WALs. Collection is deferred, never skipped: each call runs with
   the GC paused and restores the previous state on exit — including
   around the per-line Python fallback, which allocates the same kind
   of short-lived containers. */
#define GC_PAUSED_METH(name)                                          \
    static PyObject *name##_gcp(PyObject *self, PyObject *args) {     \
        int was_enabled = PyGC_Disable();                             \
        PyObject *r = name(self, args);                               \
        if (was_enabled) PyGC_Enable();                               \
        return r;                                                     \
    }
GC_PAUSED_METH(ingest_chunk)
GC_PAUSED_METH(register_encode)
GC_PAUSED_METH(register_add_encode)
GC_PAUSED_METH(frontier_absorb)

static PyMethodDef methods[] = {
    {"parse", parse, METH_VARARGS,
     "parse(history) -> tuple | None\n"
     "C-speed pass A/B + spine/prefix of the columnar Elle builder."},
    {"ingest_chunk", ingest_chunk_gcp, METH_VARARGS,
     "ingest_chunk(data, final, fallback, skip, torn)\n"
     " -> (ops, consumed, torn, truncated)\n"
     "Newline scan + JSON parse with WalTailer.poll's torn contract."},
    {"register_encode", register_encode_gcp, METH_VARARGS,
     "register_encode(state) -> (next, next_slot, n_slots, bailed)\n"
     "Event-encode twin of LiveRegisterEncoder.encode_resolved."},
    {"register_add_encode", register_add_encode_gcp, METH_VARARGS,
     "register_add_encode(ops, start, add_state, enc_state)\n"
     " -> (next, next_slot, n_slots, enc_ran, bailed)\n"
     "Fused add_many + encode_resolved: one walk per chunk."},
    {"frontier_absorb", frontier_absorb_gcp, METH_VARARGS,
     "frontier_absorb(...) -> None | ('dead', e) | new state\n"
     "Config-closure twin of FrontierSession.absorb (cas register)."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_columnar_c_torch",
    "C-speed columnar history parser and host ingest spine (see "
    "columnar_ext.c)", -1, methods, NULL, NULL, NULL, NULL};

#ifdef __cplusplus
extern "C" {
#endif
PyMODINIT_FUNC PyInit__columnar_c_torch(void) {
    if (spine_init() < 0) return NULL;
    return PyModule_Create(&moduledef);
}
#ifdef __cplusplus
}
#endif

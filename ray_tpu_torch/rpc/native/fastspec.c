/* fastspec — native codec for the per-call submit records.
 *
 * Reference obligation (SURVEY §2.5): the reference's per-call submit
 * path is C++ end-to-end (core_worker/transport/actor_task_submitter.cc +
 * normal_task_submitter.cc + protobuf TaskSpec); a pickled 20-field
 * Python dataclass graph per call is the single biggest per-call CPU
 * cost in this runtime's equivalent. This module packs/unpacks the
 * submit record in one buffer.
 *
 * v1 — actor call (pack/unpack):
 *   magic "RTFS" | ver u8=1 |
 *   seq u64 | num_returns u32 | port u32 |
 *   7 x (len u32 | bytes):   task_id, job_id, actor_id, caller_worker_id,
 *                            host, method, args_payload
 *
 * v2 — normal task (pack_task/unpack_task), the lease-cached dispatch
 * channel's record:
 *   magic "RTFS" | ver u8=2 |
 *   num_returns u32 | port u32 |
 *   8 x (len u32 | bytes):   task_id, job_id, caller_worker_id, host,
 *                            qualname, serialized_func, args_payload,
 *                            display_name
 *
 * The args payload is ONE pickle of the plain (args, kwargs) made by the
 * caller; everything else is fixed metadata. CPython C API only (no
 * pybind11 in this image); compiled on first import like shm_store.cc.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <endian.h>
#include <stdint.h>
#include <string.h>

#include "fastframe.h" /* shared little-endian helpers (pure C) */

static const char MAGIC[4] = {'R', 'T', 'F', 'S'};
static const uint8_t VERSION = 1;
static const uint8_t TASK_VERSION = 2;
#define N_BLOBS 7
#define N_TASK_BLOBS 8

/* Wire integers are little-endian: the pure-Python fallback decoder
 * (struct "<QII"/"<I") must read what this codec writes on any host. */
static void put_u32(char **p, uint32_t v) { ff_put_u32((unsigned char *)*p, v); *p += 4; }
static void put_u64(char **p, uint64_t v) { ff_put_u64((unsigned char *)*p, v); *p += 8; }
static uint32_t get_u32(const char **p) { uint32_t v = ff_get_u32((const unsigned char *)*p); *p += 4; return v; }
static uint64_t get_u64(const char **p) { uint64_t v = ff_get_u64((const unsigned char *)*p); *p += 8; return v; }

static PyObject *
fastspec_pack(PyObject *self, PyObject *args)
{
    Py_buffer blobs[N_BLOBS];
    unsigned long long seq;
    unsigned int num_returns;
    unsigned int port;
    /* task_id job_id actor_id caller_wid host method payload seq nret port */
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*y*KII",
                          &blobs[0], &blobs[1], &blobs[2], &blobs[3],
                          &blobs[4], &blobs[5], &blobs[6],
                          &seq, &num_returns, &port)) {
        return NULL;
    }
    Py_ssize_t total = 4 + 1 + 8 + 4 + 4;
    for (int i = 0; i < N_BLOBS; i++) {
        if ((uint64_t)blobs[i].len > UINT32_MAX) {
            for (int j = 0; j < N_BLOBS; j++) PyBuffer_Release(&blobs[j]);
            PyErr_SetString(PyExc_OverflowError,
                            "fastspec blob exceeds u32 length prefix");
            return NULL;
        }
        total += 4 + blobs[i].len;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, total);
    if (out == NULL) {
        for (int i = 0; i < N_BLOBS; i++) PyBuffer_Release(&blobs[i]);
        return NULL;
    }
    char *p = PyBytes_AS_STRING(out);
    memcpy(p, MAGIC, 4); p += 4;
    *p++ = (char)VERSION;
    put_u64(&p, (uint64_t)seq);
    put_u32(&p, (uint32_t)num_returns);
    put_u32(&p, (uint32_t)port);
    for (int i = 0; i < N_BLOBS; i++) {
        put_u32(&p, (uint32_t)blobs[i].len);
        memcpy(p, blobs[i].buf, blobs[i].len); p += blobs[i].len;
        PyBuffer_Release(&blobs[i]);
    }
    return out;
}

static PyObject *
fastspec_unpack(PyObject *self, PyObject *args)
{
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) {
        return NULL;
    }
    const char *p = (const char *)buf.buf;
    const char *end = p + buf.len;
    if (buf.len < 4 + 1 + 8 + 4 + 4 || memcmp(p, MAGIC, 4) != 0) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "not a fastspec buffer");
        return NULL;
    }
    p += 4;
    uint8_t ver = (uint8_t)*p++;
    if (ver != VERSION) {
        PyBuffer_Release(&buf);
        PyErr_Format(PyExc_ValueError, "fastspec version %d unsupported", ver);
        return NULL;
    }
    uint64_t seq = get_u64(&p);
    uint32_t num_returns = get_u32(&p);
    uint32_t port = get_u32(&p);

    PyObject *tuple = PyTuple_New(N_BLOBS + 3);
    if (tuple == NULL) {
        PyBuffer_Release(&buf);
        return NULL;
    }
    for (int i = 0; i < N_BLOBS; i++) {
        if (p + 4 > end) goto corrupt;
        uint32_t len = get_u32(&p);
        if ((Py_ssize_t)len > end - p) goto corrupt;
        PyObject *b = PyBytes_FromStringAndSize(p, (Py_ssize_t)len);
        if (b == NULL) {
            Py_DECREF(tuple);
            PyBuffer_Release(&buf);
            return NULL;
        }
        PyTuple_SET_ITEM(tuple, i, b);
        p += len;
    }
    PyTuple_SET_ITEM(tuple, N_BLOBS, PyLong_FromUnsignedLongLong(seq));
    PyTuple_SET_ITEM(tuple, N_BLOBS + 1, PyLong_FromUnsignedLong(num_returns));
    PyTuple_SET_ITEM(tuple, N_BLOBS + 2, PyLong_FromUnsignedLong(port));
    PyBuffer_Release(&buf);
    return tuple;

corrupt:
    Py_DECREF(tuple);
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "truncated fastspec buffer");
    return NULL;
}

/* v2 pack/unpack ride the pure-C record codec in fastframe.h
 * (ff_task_write/ff_task_parse) — the same functions the sanitizer
 * harness (cpp/test/tsan_fastframe.cc) drives under TSAN/ASAN with
 * concurrent writers, so the production parse path IS the audited
 * path. */

static PyObject *
fastspec_pack_task(PyObject *self, PyObject *args)
{
    Py_buffer blobs[N_TASK_BLOBS];
    unsigned int num_returns;
    unsigned int port;
    /* task_id job_id caller_wid host qualname func payload name
     * num_returns port */
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*y*y*II",
                          &blobs[0], &blobs[1], &blobs[2], &blobs[3],
                          &blobs[4], &blobs[5], &blobs[6], &blobs[7],
                          &num_returns, &port)) {
        return NULL;
    }
    ff_task_record rec;
    rec.num_returns = (uint32_t)num_returns;
    rec.port = (uint32_t)port;
    for (int i = 0; i < N_TASK_BLOBS; i++) {
        if ((uint64_t)blobs[i].len > UINT32_MAX) {
            for (int j = 0; j < N_TASK_BLOBS; j++)
                PyBuffer_Release(&blobs[j]);
            PyErr_SetString(PyExc_OverflowError,
                            "fastspec blob exceeds u32 length prefix");
            return NULL;
        }
        rec.blobs[i].ptr = (const unsigned char *)blobs[i].buf;
        rec.blobs[i].len = (uint32_t)blobs[i].len;
    }
    PyObject *out =
        PyBytes_FromStringAndSize(NULL, (Py_ssize_t)ff_task_size(&rec));
    if (out == NULL) {
        for (int i = 0; i < N_TASK_BLOBS; i++) PyBuffer_Release(&blobs[i]);
        return NULL;
    }
    ff_task_write(&rec, (unsigned char *)PyBytes_AS_STRING(out));
    for (int i = 0; i < N_TASK_BLOBS; i++) PyBuffer_Release(&blobs[i]);
    return out;
}

static PyObject *
fastspec_unpack_task(PyObject *self, PyObject *args)
{
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) {
        return NULL;
    }
    ff_task_record rec;
    int rc = ff_task_parse((const unsigned char *)buf.buf,
                           (size_t)buf.len, &rec);
    if (rc != 0) {
        const unsigned char *b = (const unsigned char *)buf.buf;
        if (rc == -1 && buf.len >= 5 && memcmp(b, MAGIC, 4) == 0 &&
            b[4] != FF_SPEC_TASK_VERSION) {
            PyErr_Format(PyExc_ValueError,
                         "fastspec task version %d unsupported", b[4]);
        } else if (rc == -1 && (buf.len < 4 ||
                                memcmp(b, MAGIC, 4) != 0)) {
            PyErr_SetString(PyExc_ValueError, "not a fastspec buffer");
        } else {
            /* magic + supported version but short/corrupt body (parse
             * returned -1 for len < header or -2 mid-blob) */
            PyErr_SetString(PyExc_ValueError,
                            "truncated fastspec buffer");
        }
        PyBuffer_Release(&buf);
        return NULL;
    }
    PyObject *tuple = PyTuple_New(N_TASK_BLOBS + 2);
    if (tuple == NULL) {
        PyBuffer_Release(&buf);
        return NULL;
    }
    for (int i = 0; i < N_TASK_BLOBS; i++) {
        PyObject *b = PyBytes_FromStringAndSize(
            (const char *)rec.blobs[i].ptr, (Py_ssize_t)rec.blobs[i].len);
        if (b == NULL) {
            Py_DECREF(tuple);
            PyBuffer_Release(&buf);
            return NULL;
        }
        PyTuple_SET_ITEM(tuple, i, b);
    }
    PyTuple_SET_ITEM(tuple, N_TASK_BLOBS,
                     PyLong_FromUnsignedLong(rec.num_returns));
    PyTuple_SET_ITEM(tuple, N_TASK_BLOBS + 1,
                     PyLong_FromUnsignedLong(rec.port));
    PyBuffer_Release(&buf);
    return tuple;
}

static PyMethodDef FastspecMethods[] = {
    {"pack", fastspec_pack, METH_VARARGS,
     "pack(task_id, job_id, actor_id, caller_wid, host, method, payload, "
     "seq, num_returns, port) -> bytes"},
    {"unpack", fastspec_unpack, METH_VARARGS,
     "unpack(buf) -> (task_id, job_id, actor_id, caller_wid, host, method, "
     "payload, seq, num_returns, port)"},
    {"pack_task", fastspec_pack_task, METH_VARARGS,
     "pack_task(task_id, job_id, caller_wid, host, qualname, func, payload, "
     "name, num_returns, port) -> bytes"},
    {"unpack_task", fastspec_unpack_task, METH_VARARGS,
     "unpack_task(buf) -> (task_id, job_id, caller_wid, host, qualname, "
     "func, payload, name, num_returns, port)"},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef fastspecmodule = {
    PyModuleDef_HEAD_INIT, "_fastspec",
    "native actor-call submit record codec", -1, FastspecMethods
};

PyMODINIT_FUNC
PyInit__fastspec(void)
{
    return PyModule_Create(&fastspecmodule);
}

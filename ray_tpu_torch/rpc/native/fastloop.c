/* fastloop.c — C dispatch loop for the actor-call and normal-task hot
 * paths.
 *
 * SURVEY §2.5 native-core mandate: the reference's per-call path is C++
 * end-to-end (src/ray/core_worker/transport/normal_task_submitter.cc
 * PushNormalTask, src/ray/rpc/grpc_server.h); ours was asyncio Python,
 * and profiling put ~230 µs/call in asyncio scheduling + coroutine
 * resumption alone (PERF_PLAN.md round-4 appendix).  This extension
 * removes that floor for eligible actor calls:
 *
 *   Server — one C thread per worker: poll() accept/read loop, frames
 *     dispatched straight into a Python handler while holding the GIL
 *     (the handler is the worker's fast-execute entry; for
 *     deferred/threaded execution it returns None and later calls
 *     send_reply() from any thread).
 *   Client — blocking writes from the caller's own thread (no event
 *     loop hop) + one C reader thread completing replies via a Python
 *     callback.
 *
 * Wire format per frame, both directions:
 *   [u32 payload_len][u64 req_id][payload bytes]
 * req_id is the actor-call sequence number; the reply carries the same
 * id.  Transport failures surface as on_reply(0, None) client-side and
 * as connection teardown server-side — both sides then fall back to the
 * ordinary asyncio RPC path, whose seq-dedup replay protocol makes the
 * switchover exactly-once.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

/* Wire codec + robust writer live in fastframe.h (pure C, no Python)
 * so run_tsan.sh can drive them under the sanitizers. */
#include "fastframe.h"

#define HDR_SIZE FF_HDR_SIZE
#define MAX_FRAME FF_MAX_FRAME
#define write_frame_fd ff_write_frame_fd
#define get_u32 ff_get_u32
#define get_u64 ff_get_u64

/* ------------------------------------------------------------------ */
/* Server                                                             */
/* ------------------------------------------------------------------ */

typedef struct Conn {
    uint64_t id;
    int fd;
    int dead;
    int refs; /* registry + transient send_reply holders */
    pthread_mutex_t wmutex;
    unsigned char *buf;
    size_t cap, len;
    struct Conn *next;
} Conn;

typedef struct {
    PyObject_HEAD
    int listen_fd;
    int port;
    int stop_pipe[2];
    pthread_t thread;
    int running;
    PyObject *handler;
    pthread_mutex_t reg_mutex;
    Conn *conns;
    uint64_t next_conn_id;
} ServerObject;

static void conn_decref(Conn *c) {
    /* caller holds reg_mutex */
    if (--c->refs == 0) {
        close(c->fd);
        pthread_mutex_destroy(&c->wmutex);
        free(c->buf);
        free(c);
    }
}

static void server_drop_conn(ServerObject *self, Conn *c) {
    pthread_mutex_lock(&self->reg_mutex);
    if (!c->dead) {
        c->dead = 1;
        Conn **pp = &self->conns;
        while (*pp && *pp != c) pp = &(*pp)->next;
        if (*pp) *pp = c->next;
        shutdown(c->fd, SHUT_RDWR);
        conn_decref(c);
    }
    pthread_mutex_unlock(&self->reg_mutex);
}

/* Dispatch every complete frame in c->buf.  Runs on the server thread
 * without the GIL held on entry. */
static int server_dispatch(ServerObject *self, Conn *c) {
    size_t off = 0;
    int rc = 0;
    for (;;) {
        uint64_t req_id;
        const unsigned char *payload;
        uint32_t plen;
        int fr = ff_next_frame(c->buf, c->len, &off, &req_id, &payload,
                               &plen);
        if (fr <= 0) { if (fr < 0) rc = -1; break; }
        PyGILState_STATE g = PyGILState_Ensure();
        PyObject *res = PyObject_CallFunction(
            self->handler, "KKy#", (unsigned long long)c->id,
            (unsigned long long)req_id,
            (const char *)payload, (Py_ssize_t)plen);
        if (res == NULL) {
            /* Handler bug: the Python side wraps user errors into reply
             * payloads, so an escape here is unexpected.  Surface it and
             * kill the connection — the caller's resend protocol takes
             * the slow path from there. */
            PyErr_WriteUnraisable(self->handler);
            PyGILState_Release(g);
            rc = -1;
            break;
        }
        if (res == Py_None) {
            /* reply deferred: Python will call send_reply() later */
            Py_DECREF(res);
            PyGILState_Release(g);
        } else {
            char *pbuf;
            Py_ssize_t pn;
            if (PyBytes_AsStringAndSize(res, &pbuf, &pn) < 0) {
                PyErr_WriteUnraisable(self->handler);
                Py_DECREF(res);
                PyGILState_Release(g);
                rc = -1;
                break;
            }
            /* write with the GIL released; wmutex orders us against any
             * concurrent send_reply() for deferred frames */
            Py_BEGIN_ALLOW_THREADS
            pthread_mutex_lock(&c->wmutex);
            rc = write_frame_fd(c->fd, req_id, pbuf, (size_t)pn);
            pthread_mutex_unlock(&c->wmutex);
            Py_END_ALLOW_THREADS
            Py_DECREF(res);
            PyGILState_Release(g);
            if (rc < 0) break;
        }
    }
    if (off > 0) {
        memmove(c->buf, c->buf + off, c->len - off);
        c->len -= off;
    }
    return rc;
}

static void *server_main(void *arg) {
    ServerObject *self = (ServerObject *)arg;
    for (;;) {
        /* snapshot conns under the registry lock */
        pthread_mutex_lock(&self->reg_mutex);
        size_t nconn = 0;
        for (Conn *c = self->conns; c; c = c->next) nconn++;
        struct pollfd *pfds = malloc((nconn + 2) * sizeof(*pfds));
        Conn **order = malloc((nconn + 1) * sizeof(*order));
        if (!pfds || !order) {
            pthread_mutex_unlock(&self->reg_mutex);
            free(pfds); free(order);
            return NULL;
        }
        pfds[0].fd = self->stop_pipe[0];
        pfds[0].events = POLLIN;
        pfds[1].fd = self->listen_fd;
        pfds[1].events = POLLIN;
        size_t i = 0;
        for (Conn *c = self->conns; c; c = c->next, i++) {
            c->refs++; /* held across the poll */
            order[i] = c;
            pfds[i + 2].fd = c->fd;
            pfds[i + 2].events = POLLIN;
        }
        pthread_mutex_unlock(&self->reg_mutex);

        int pr = poll(pfds, nconn + 2, 1000);
        int stopping = 0;
        if (pr > 0) {
            if (pfds[0].revents) stopping = 1;
            if (!stopping && (pfds[1].revents & POLLIN)) {
                int fd = accept(self->listen_fd, NULL, NULL);
                if (fd >= 0) {
                    int one = 1;
                    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one,
                               sizeof(one));
                    Conn *c = calloc(1, sizeof(Conn));
                    if (c) {
                        c->fd = fd;
                        c->refs = 1;
                        pthread_mutex_init(&c->wmutex, NULL);
                        pthread_mutex_lock(&self->reg_mutex);
                        c->id = ++self->next_conn_id;
                        c->next = self->conns;
                        self->conns = c;
                        pthread_mutex_unlock(&self->reg_mutex);
                    } else {
                        close(fd);
                    }
                }
            }
            for (i = 0; !stopping && i < nconn; i++) {
                Conn *c = order[i];
                short rev = pfds[i + 2].revents;
                if (!rev || c->dead) continue;
                if (rev & POLLIN) {
                    if (c->cap - c->len < 65536) {
                        size_t ncap = c->cap ? c->cap * 2 : 131072;
                        while (ncap - c->len < 65536) ncap *= 2;
                        unsigned char *nb = realloc(c->buf, ncap);
                        if (!nb) { server_drop_conn(self, c); continue; }
                        c->buf = nb;
                        c->cap = ncap;
                    }
                    ssize_t n = recv(c->fd, c->buf + c->len,
                                     c->cap - c->len, 0);
                    if (n <= 0) {
                        if (n < 0 && (errno == EINTR || errno == EAGAIN))
                            continue;
                        server_drop_conn(self, c);
                        continue;
                    }
                    c->len += (size_t)n;
                    if (server_dispatch(self, c) < 0)
                        server_drop_conn(self, c);
                } else if (rev & (POLLHUP | POLLERR | POLLNVAL)) {
                    server_drop_conn(self, c);
                }
            }
        }
        /* release the poll refs */
        pthread_mutex_lock(&self->reg_mutex);
        for (i = 0; i < nconn; i++) conn_decref(order[i]);
        pthread_mutex_unlock(&self->reg_mutex);
        free(pfds);
        free(order);
        if (stopping || pr < 0) break;
    }
    return NULL;
}

static PyObject *Server_start(ServerObject *self, PyObject *noargs) {
    (void)noargs;
    if (self->running) Py_RETURN_NONE;
    if (pthread_create(&self->thread, NULL, server_main, self) != 0)
        return PyErr_SetFromErrno(PyExc_OSError);
    self->running = 1;
    Py_RETURN_NONE;
}

static PyObject *Server_stop(ServerObject *self, PyObject *noargs) {
    (void)noargs;
    if (self->running) {
        ssize_t r = write(self->stop_pipe[1], "x", 1);
        (void)r;
        Py_BEGIN_ALLOW_THREADS
        pthread_join(self->thread, NULL);
        Py_END_ALLOW_THREADS
        self->running = 0;
        pthread_mutex_lock(&self->reg_mutex);
        while (self->conns) {
            Conn *c = self->conns;
            self->conns = c->next;
            c->dead = 1;
            shutdown(c->fd, SHUT_RDWR);
            conn_decref(c);
        }
        pthread_mutex_unlock(&self->reg_mutex);
    }
    Py_RETURN_NONE;
}

static PyObject *Server_send_reply(ServerObject *self, PyObject *args) {
    unsigned long long conn_id, req_id;
    Py_buffer payload;
    if (!PyArg_ParseTuple(args, "KKy*", &conn_id, &req_id, &payload))
        return NULL;
    pthread_mutex_lock(&self->reg_mutex);
    Conn *c = self->conns;
    while (c && c->id != conn_id) c = c->next;
    if (c) c->refs++;
    pthread_mutex_unlock(&self->reg_mutex);
    if (!c) {
        PyBuffer_Release(&payload);
        Py_RETURN_FALSE; /* peer gone: its resend protocol recovers */
    }
    int rc;
    Py_BEGIN_ALLOW_THREADS
    pthread_mutex_lock(&c->wmutex);
    rc = write_frame_fd(c->fd, (uint64_t)req_id, payload.buf, payload.len);
    pthread_mutex_unlock(&c->wmutex);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&payload);
    pthread_mutex_lock(&self->reg_mutex);
    conn_decref(c);
    pthread_mutex_unlock(&self->reg_mutex);
    if (rc < 0) Py_RETURN_FALSE;
    Py_RETURN_TRUE;
}

static PyObject *Server_get_port(ServerObject *self, void *closure) {
    (void)closure;
    return PyLong_FromLong(self->port);
}

static int Server_init(ServerObject *self, PyObject *args, PyObject *kw) {
    static char *kwlist[] = {"handler", "host", NULL};
    PyObject *handler;
    const char *host = "0.0.0.0";
    if (!PyArg_ParseTupleAndKeywords(args, kw, "O|s", kwlist, &handler,
                                     &host))
        return -1;
    if (!PyCallable_Check(handler)) {
        PyErr_SetString(PyExc_TypeError, "handler must be callable");
        return -1;
    }
    Py_INCREF(handler);
    self->handler = handler;
    self->listen_fd = -1;
    self->stop_pipe[0] = self->stop_pipe[1] = -1;
    self->running = 0;
    self->conns = NULL;
    self->next_conn_id = 0;
    pthread_mutex_init(&self->reg_mutex, NULL);

    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) goto oserr;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    struct sockaddr_in addr;
    memset(&addr, 0, sizeof(addr));
    addr.sin_family = AF_INET;
    addr.sin_port = 0;
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1)
        addr.sin_addr.s_addr = htonl(INADDR_ANY);
    if (bind(fd, (struct sockaddr *)&addr, sizeof(addr)) < 0 ||
        listen(fd, 128) < 0) {
        close(fd);
        goto oserr;
    }
    socklen_t alen = sizeof(addr);
    getsockname(fd, (struct sockaddr *)&addr, &alen);
    self->port = ntohs(addr.sin_port);
    self->listen_fd = fd;
    if (pipe(self->stop_pipe) < 0) {
        close(fd);
        self->listen_fd = -1;
        goto oserr;
    }
    return 0;
oserr:
    PyErr_SetFromErrno(PyExc_OSError);
    return -1;
}

static void Server_dealloc(ServerObject *self) {
    if (self->running) {
        PyObject *r = Server_stop(self, NULL);
        Py_XDECREF(r);
    }
    if (self->listen_fd >= 0) close(self->listen_fd);
    if (self->stop_pipe[0] >= 0) close(self->stop_pipe[0]);
    if (self->stop_pipe[1] >= 0) close(self->stop_pipe[1]);
    pthread_mutex_destroy(&self->reg_mutex);
    Py_XDECREF(self->handler);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyMethodDef Server_methods[] = {
    {"start", (PyCFunction)Server_start, METH_NOARGS, NULL},
    {"stop", (PyCFunction)Server_stop, METH_NOARGS, NULL},
    {"send_reply", (PyCFunction)Server_send_reply, METH_VARARGS,
     "send_reply(conn_id, req_id, payload) -> bool"},
    {NULL, NULL, 0, NULL},
};

static PyGetSetDef Server_getset[] = {
    {"port", (getter)Server_get_port, NULL, NULL, NULL},
    {NULL, NULL, NULL, NULL, NULL},
};

static PyTypeObject ServerType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_fastloop.Server",
    .tp_basicsize = sizeof(ServerObject),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)Server_init,
    .tp_dealloc = (destructor)Server_dealloc,
    .tp_methods = Server_methods,
    .tp_getset = Server_getset,
};

/* ------------------------------------------------------------------ */
/* Client                                                             */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_HEAD
    int fd;
    int running;
    int closed;
    pthread_t thread;
    pthread_mutex_t wmutex;
    PyObject *on_reply;
} ClientObject;

static void *client_main(void *arg) {
    ClientObject *self = (ClientObject *)arg;
    unsigned char *buf = NULL;
    size_t cap = 0, len = 0;
    for (;;) {
        if (cap - len < 65536) {
            size_t ncap = cap ? cap * 2 : 131072;
            while (ncap - len < 65536) ncap *= 2;
            unsigned char *nb = realloc(buf, ncap);
            if (!nb) break;
            buf = nb;
            cap = ncap;
        }
        ssize_t n = recv(self->fd, buf + len, cap - len, 0);
        if (n <= 0) {
            if (n < 0 && errno == EINTR) continue;
            break;
        }
        len += (size_t)n;
        size_t off = 0;
        int bad = 0;
        for (;;) {
            uint64_t req_id;
            const unsigned char *payload;
            uint32_t plen;
            int fr = ff_next_frame(buf, len, &off, &req_id, &payload,
                                   &plen);
            if (fr <= 0) { bad = (fr < 0); break; }
            PyGILState_STATE g = PyGILState_Ensure();
            PyObject *r = PyObject_CallFunction(
                self->on_reply, "Ky#", (unsigned long long)req_id,
                (const char *)payload, (Py_ssize_t)plen);
            if (r == NULL)
                PyErr_WriteUnraisable(self->on_reply);
            Py_XDECREF(r);
            PyGILState_Release(g);
        }
        if (bad) break;
        if (off > 0) {
            memmove(buf, buf + off, len - off);
            len -= off;
        }
    }
    free(buf);
    /* connection over: tell Python unless close() was requested (then the
     * owner already knows and the interpreter may be tearing down) */
    if (!self->closed) {
        PyGILState_STATE g = PyGILState_Ensure();
        PyObject *r =
            PyObject_CallFunction(self->on_reply, "KO", 0ULL, Py_None);
        if (r == NULL) PyErr_WriteUnraisable(self->on_reply);
        Py_XDECREF(r);
        PyGILState_Release(g);
    }
    return NULL;
}

static int Client_init(ClientObject *self, PyObject *args, PyObject *kw) {
    static char *kwlist[] = {"host", "port", "on_reply", "timeout", NULL};
    const char *host;
    int port;
    PyObject *on_reply;
    double timeout = 10.0;
    if (!PyArg_ParseTupleAndKeywords(args, kw, "siO|d", kwlist, &host,
                                     &port, &on_reply, &timeout))
        return -1;
    if (!PyCallable_Check(on_reply)) {
        PyErr_SetString(PyExc_TypeError, "on_reply must be callable");
        return -1;
    }
    self->fd = -1;
    self->running = 0;
    self->closed = 0;
    pthread_mutex_init(&self->wmutex, NULL);

    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) {
        PyErr_SetFromErrno(PyExc_OSError);
        return -1;
    }
    struct sockaddr_in addr;
    memset(&addr, 0, sizeof(addr));
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
        close(fd);
        PyErr_SetString(PyExc_OSError, "fastloop client needs an IPv4 "
                                       "address, not a hostname");
        return -1;
    }
    /* honour the timeout: non-blocking connect + poll, then back to
     * blocking mode (a raw connect() can hang ~2 min on a blackholed
     * port, and callers may be on an event loop) */
    int flags = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, flags | O_NONBLOCK);
    int rc;
    Py_BEGIN_ALLOW_THREADS
    rc = connect(fd, (struct sockaddr *)&addr, sizeof(addr));
    if (rc < 0 && errno == EINPROGRESS) {
        struct pollfd p = {.fd = fd, .events = POLLOUT};
        int pr = poll(&p, 1, (int)(timeout * 1000.0));
        if (pr == 1) {
            int soerr = 0;
            socklen_t slen = sizeof(soerr);
            getsockopt(fd, SOL_SOCKET, SO_ERROR, &soerr, &slen);
            if (soerr == 0) {
                rc = 0;
            } else {
                errno = soerr;
                rc = -1;
            }
        } else {
            errno = ETIMEDOUT;
            rc = -1;
        }
    }
    Py_END_ALLOW_THREADS
    if (rc < 0) {
        close(fd);
        PyErr_SetFromErrno(PyExc_ConnectionError);
        return -1;
    }
    fcntl(fd, F_SETFL, flags);
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    self->fd = fd;
    Py_INCREF(on_reply);
    self->on_reply = on_reply;
    if (pthread_create(&self->thread, NULL, client_main, self) != 0) {
        close(fd);
        self->fd = -1;
        PyErr_SetFromErrno(PyExc_OSError);
        return -1;
    }
    self->running = 1;
    return 0;
}

static PyObject *Client_call(ClientObject *self, PyObject *args) {
    unsigned long long req_id;
    Py_buffer payload;
    if (!PyArg_ParseTuple(args, "Ky*", &req_id, &payload)) return NULL;
    if (self->fd < 0 || self->closed) {
        PyBuffer_Release(&payload);
        PyErr_SetString(PyExc_ConnectionError, "fastloop client closed");
        return NULL;
    }
    int rc;
    Py_BEGIN_ALLOW_THREADS
    pthread_mutex_lock(&self->wmutex);
    rc = write_frame_fd(self->fd, (uint64_t)req_id, payload.buf,
                        payload.len);
    pthread_mutex_unlock(&self->wmutex);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&payload);
    if (rc < 0) {
        PyErr_SetString(PyExc_ConnectionError, "fastloop write failed");
        return NULL;
    }
    Py_RETURN_NONE;
}

static PyObject *Client_close(ClientObject *self, PyObject *noargs) {
    (void)noargs;
    self->closed = 1;
    if (self->fd >= 0) shutdown(self->fd, SHUT_RDWR);
    if (self->running) {
        Py_BEGIN_ALLOW_THREADS
        pthread_join(self->thread, NULL);
        Py_END_ALLOW_THREADS
        self->running = 0;
    }
    if (self->fd >= 0) {
        close(self->fd);
        self->fd = -1;
    }
    Py_RETURN_NONE;
}

static void Client_dealloc(ClientObject *self) {
    PyObject *r = Client_close(self, NULL);
    Py_XDECREF(r);
    pthread_mutex_destroy(&self->wmutex);
    Py_XDECREF(self->on_reply);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyMethodDef Client_methods[] = {
    {"call", (PyCFunction)Client_call, METH_VARARGS,
     "call(req_id, payload) — write one frame; replies arrive via "
     "on_reply(req_id, payload) on the reader thread"},
    {"close", (PyCFunction)Client_close, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject ClientType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_fastloop.Client",
    .tp_basicsize = sizeof(ClientObject),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)Client_init,
    .tp_dealloc = (destructor)Client_dealloc,
    .tp_methods = Client_methods,
};

static struct PyModuleDef fastloop_module = {
    PyModuleDef_HEAD_INIT, "_fastloop",
    "C dispatch loop for actor-call push/reply (see fastloop.c header)",
    -1, NULL, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__fastloop(void) {
    if (PyType_Ready(&ServerType) < 0 || PyType_Ready(&ClientType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&fastloop_module);
    if (!m) return NULL;
    Py_INCREF(&ServerType);
    PyModule_AddObject(m, "Server", (PyObject *)&ServerType);
    Py_INCREF(&ClientType);
    PyModule_AddObject(m, "Client", (PyObject *)&ClientType);
    return m;
}

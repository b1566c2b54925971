/* fastframe.h — the wire layer shared by fastloop.c and fastspec.c.
 *
 * Pure C (no Python.h): the frame codec and the robust fd writer live
 * here so `scripts/run_tsan.sh` can compile them into a sanitizer
 * harness (cpp/test/tsan_fastloop.cc) without an embedded interpreter.
 * Everything is little-endian on the wire — the pure-Python fallback
 * decoder (struct "<QII"/"<I") must read what this code writes on any
 * host.
 *
 * Frame format (both directions of the fastloop channel):
 *   [u32 payload_len][u64 req_id][payload bytes]
 */
#ifndef RT_FASTFRAME_H
#define RT_FASTFRAME_H

#include <errno.h>
#include <poll.h>
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <sys/uio.h>

#define FF_HDR_SIZE 12u
#define FF_MAX_FRAME (1u << 30) /* 1 GiB sanity cap */

static inline void ff_put_u32(unsigned char *p, uint32_t v) {
    p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
    p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}
static inline uint32_t ff_get_u32(const unsigned char *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
           ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}
static inline void ff_put_u64(unsigned char *p, uint64_t v) {
    ff_put_u32(p, (uint32_t)(v & 0xffffffffu));
    ff_put_u32(p + 4, (uint32_t)(v >> 32));
}
static inline uint64_t ff_get_u64(const unsigned char *p) {
    return (uint64_t)ff_get_u32(p) | ((uint64_t)ff_get_u32(p + 4) << 32);
}

/* Parse the next complete frame at *off.  Returns 1 and advances *off
 * past the frame when one is complete, 0 when more bytes are needed,
 * -1 on a corrupt length prefix (connection must drop). */
static inline int ff_next_frame(const unsigned char *buf, size_t len,
                                size_t *off, uint64_t *req_id,
                                const unsigned char **payload,
                                uint32_t *plen) {
    if (len - *off < FF_HDR_SIZE) return 0;
    uint32_t n = ff_get_u32(buf + *off);
    if (n > FF_MAX_FRAME) return -1;
    if (len - *off < FF_HDR_SIZE + (size_t)n) return 0;
    *req_id = ff_get_u64(buf + *off + 4);
    *payload = buf + *off + FF_HDR_SIZE;
    *plen = n;
    *off += FF_HDR_SIZE + n;
    return 1;
}

/* Robust write of a full frame on a (possibly non-blocking) fd; the
 * caller must serialize concurrent writers on the same fd (fastloop
 * holds the connection's write mutex) and must NOT hold the GIL. */
static inline int ff_write_frame_fd(int fd, uint64_t req_id,
                                    const char *payload, size_t len) {
    unsigned char hdr[FF_HDR_SIZE];
    ff_put_u32(hdr, (uint32_t)len);
    ff_put_u64(hdr + 4, req_id);
    struct iovec iov[2] = {
        {.iov_base = hdr, .iov_len = FF_HDR_SIZE},
        {.iov_base = (void *)payload, .iov_len = len},
    };
    size_t total = FF_HDR_SIZE + len, sent = 0;
    while (sent < total) {
        ssize_t n = writev(fd, iov, iov[1].iov_len ? 2 : 1);
        if (n < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                struct pollfd p = {.fd = fd, .events = POLLOUT};
                if (poll(&p, 1, 30000) <= 0) return -1;
                continue;
            }
            return -1;
        }
        sent += (size_t)n;
        size_t left = (size_t)n;
        if (iov[0].iov_len) {
            size_t take = left < iov[0].iov_len ? left : iov[0].iov_len;
            iov[0].iov_base = (char *)iov[0].iov_base + take;
            iov[0].iov_len -= take;
            left -= take;
        }
        iov[1].iov_base = (char *)iov[1].iov_base + left;
        iov[1].iov_len -= left;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* fastspec v2 (normal-task) record codec — pure C, shared by          */
/* fastspec.c (the CPython extension) and cpp/test/tsan_fastframe.cc   */
/* (the sanitizer harness), so concurrent record parse is TSAN/ASAN    */
/* covered without an embedded interpreter.  Wire form (fastspec.c     */
/* header comment):                                                    */
/*   magic "RTFS" | ver u8=2 | num_returns u32 | port u32 |            */
/*   8 x (len u32 | bytes): task_id, job_id, caller_worker_id, host,   */
/*                          qualname, serialized_func, args_payload,   */
/*                          display_name                               */
/* ------------------------------------------------------------------ */

#define FF_SPEC_MAGIC "RTFS"
#define FF_SPEC_TASK_VERSION 2u
#define FF_TASK_NBLOBS 8u
#define FF_TASK_HDR (4u + 1u + 4u + 4u)

typedef struct {
    const unsigned char *ptr;
    uint32_t len;
} ff_span;

typedef struct {
    uint32_t num_returns;
    uint32_t port;
    ff_span blobs[FF_TASK_NBLOBS];
} ff_task_record;

/* Packed byte size of a v2 record (callers allocate; this layer never
 * does — fastframe.h stays allocation-free by contract, enforced by the
 * native-race-audit analysis pass). */
static inline size_t ff_task_size(const ff_task_record *rec) {
    size_t total = FF_TASK_HDR;
    for (unsigned i = 0; i < FF_TASK_NBLOBS; i++)
        total += 4 + (size_t)rec->blobs[i].len;
    return total;
}

/* Serialize into `out` (at least ff_task_size(rec) bytes); returns the
 * number of bytes written. */
static inline size_t ff_task_write(const ff_task_record *rec,
                                   unsigned char *out) {
    unsigned char *p = out;
    memcpy(p, FF_SPEC_MAGIC, 4); p += 4;
    *p++ = (unsigned char)FF_SPEC_TASK_VERSION;
    ff_put_u32(p, rec->num_returns); p += 4;
    ff_put_u32(p, rec->port); p += 4;
    for (unsigned i = 0; i < FF_TASK_NBLOBS; i++) {
        ff_put_u32(p, rec->blobs[i].len); p += 4;
        if (rec->blobs[i].len) {
            memcpy(p, rec->blobs[i].ptr, rec->blobs[i].len);
            p += rec->blobs[i].len;
        }
    }
    return (size_t)(p - out);
}

/* Parse a v2 record.  Blob spans alias `buf` (zero-copy; the caller
 * keeps buf alive).  Returns 0 on success, -1 when buf is not a v2
 * record, -2 when truncated/corrupt. */
static inline int ff_task_parse(const unsigned char *buf, size_t len,
                                ff_task_record *rec) {
    if (len < FF_TASK_HDR || memcmp(buf, FF_SPEC_MAGIC, 4) != 0)
        return -1;
    if (buf[4] != FF_SPEC_TASK_VERSION)
        return -1;
    const unsigned char *p = buf + 5;
    const unsigned char *end = buf + len;
    rec->num_returns = ff_get_u32(p); p += 4;
    rec->port = ff_get_u32(p); p += 4;
    for (unsigned i = 0; i < FF_TASK_NBLOBS; i++) {
        if ((size_t)(end - p) < 4) return -2;
        uint32_t n = ff_get_u32(p); p += 4;
        if ((size_t)(end - p) < (size_t)n) return -2;
        rec->blobs[i].ptr = p;
        rec->blobs[i].len = n;
        p += n;
    }
    return 0;
}

#endif /* RT_FASTFRAME_H */

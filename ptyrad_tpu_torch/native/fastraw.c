/* fastraw: multithreaded strided reader for EMPAD-style .raw stacks.
 *
 * Layout: `offset` junk bytes, then N frames of H*W little-endian values
 * (itemsize bytes each), each frame followed by `gap` junk bytes (1024 for
 * EMPAD1; 0 for preprocessed EMPAD2 dumps). The last frame's gap may be
 * missing.
 *
 * The port's copy of ptyrad_tpu/native/fastraw.c with a plain C interface
 * in place of the CPython one, so it builds with the system `cc` and no
 * Python headers, and is called through ctypes (which releases the GIL):
 *
 *   int ptyrad_read_frames(const char *path, int64_t n, int64_t h,
 *                          int64_t w, int64_t itemsize, int64_t offset,
 *                          int64_t gap, int64_t nthreads, void *dst,
 *                          int64_t *need)
 *
 * copies the N frames, without their gaps, into `dst` (N*H*W*itemsize
 * bytes) from `nthreads` worker threads over an mmap of the file. Returns 0
 * on success, -1 for an invalid geometry, -2 when the file is smaller than
 * the geometry needs (`*need` then holds the bytes it needs), and an errno
 * value when the file cannot be opened, stat'ed or mapped.
 */

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

typedef struct {
    const char *src;     /* mmap base */
    char *dst;
    int64_t frame_bytes;
    int64_t stride;      /* frame_bytes + gap */
    int64_t offset;
    int64_t start_frame;
    int64_t end_frame;
} ReadJob;

static void *read_worker(void *arg)
{
    /* mmap'd source: gap-stripping is pure memcpy, no per-frame syscalls */
    ReadJob *job = (ReadJob *)arg;
    for (int64_t f = job->start_frame; f < job->end_frame; ++f) {
        memcpy(job->dst + f * job->frame_bytes,
               job->src + job->offset + f * job->stride,
               (size_t)job->frame_bytes);
    }
    return NULL;
}

int ptyrad_read_frames(const char *path, int64_t n, int64_t h, int64_t w,
                       int64_t itemsize, int64_t offset, int64_t gap,
                       int64_t nthreads, void *dst, int64_t *need)
{
    if (n <= 0 || h <= 0 || w <= 0 || itemsize <= 0 || offset < 0 || gap < 0)
        return -1;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 64) nthreads = 64;
    if (nthreads > n) nthreads = n;

    int64_t frame_bytes = h * w * itemsize;

    int fd = open(path, O_RDONLY);
    if (fd < 0)
        return errno ? errno : EIO;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        int err = errno ? errno : EIO;
        close(fd);
        return err;
    }
    /* the last frame has no trailing gap: the span needed is
     * offset + n*stride - gap bytes; a short file (a wrong geometry, or a
     * file truncated since the caller stat'd it) is refused before mapping
     * instead of reading past the mapping */
    int64_t needed = offset + n * (frame_bytes + gap) - gap;
    if (need) *need = needed;
    if (needed > (int64_t)st.st_size) {
        close(fd);
        return -2;
    }
    char *src = (char *)mmap(NULL, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    int map_err = errno;
    close(fd);
    if (src == MAP_FAILED)
        return map_err ? map_err : EIO;
    madvise(src, (size_t)st.st_size, MADV_SEQUENTIAL | MADV_WILLNEED);

    ReadJob jobs[64];
    pthread_t threads[64];
    int64_t per = (n + nthreads - 1) / nthreads;
    int64_t started = 0;
    for (int64_t t = 0; t < nthreads; ++t) {
        jobs[t].src = src;
        jobs[t].dst = (char *)dst;
        jobs[t].frame_bytes = frame_bytes;
        jobs[t].stride = frame_bytes + gap;
        jobs[t].offset = offset;
        jobs[t].start_frame = t * per;
        jobs[t].end_frame = (t + 1) * per < n ? (t + 1) * per : n;
        if (pthread_create(&threads[started], NULL, read_worker, &jobs[t]) != 0) {
            /* thread spawn failed (EAGAIN under rlimit): run inline */
            read_worker(&jobs[t]);
            continue;
        }
        ++started;
    }
    for (int64_t t = 0; t < started; ++t)
        pthread_join(threads[t], NULL);

    munmap(src, (size_t)st.st_size);
    return 0;
}

// Native I/O engine: the syscall-level hot block loop.
//
// The reference's data plane is native C++ (rwBlockSized
// source/workers/LocalWorker.cpp:1702-1814 sync; aioBlockSized :1828-2082
// via libaio). This engine provides the same two paths for the TPU-native
// framework, loaded from Python via ctypes (elbencho_tpu/utils/native.py):
//
//   - iodepth == 1: synchronous p{read,write} loop with per-op monotonic
//     latency timing and periodic interrupt-flag checks.
//   - iodepth  > 1: Linux native AIO (io_setup/io_submit/io_getevents raw
//     syscalls, <linux/aio_abi.h> — no libaio dependency) with the same
//     seed-then-refill structure as the reference: fill the ring up to
//     iodepth, then harvest completions (bounded-wait so interrupts are
//     noticed) and refill. Each ring slot gets its own 4 KiB-aligned
//     buffer, O_DIRECT-safe.
//   - engine=uring: io_uring (io_uring_setup/io_uring_enter raw syscalls,
//     no liburing dependency), same seed/refill semantics at any iodepth —
//     the idiomatic modern async path (SURVEY.md section 7 step 4).
//
// ABI (all out-params caller-allocated):
//   ioengine_run_block_loop(fd, offsets, lengths, n, is_write, buf,
//                           buf_size, iodepth, out_lat_usec, out_bytes,
//                           interrupt_flag) -> 0 or -errno
//   ioengine_run_block_loop2(... , engine) — engine: 0=auto (sync if
//     iodepth<=1 else aio), 1=sync, 2=aio, 3=io_uring
//   ioengine_uring_supported() -> 1 if the kernel accepts io_uring_setup
// Build: make -C csrc  (g++ -O2 -shared -fPIC)

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>

#include <linux/aio_abi.h>
#include <linux/io_uring.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr int kInterruptCheckInterval = 128;  // ops between flag checks
constexpr uint64_t kAlign = 4096;             // O_DIRECT-safe slot alignment

inline uint64_t now_usec() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<uint64_t>(ts.tv_sec) * 1000000ull
        + static_cast<uint64_t>(ts.tv_nsec) / 1000ull;
}

// ---------------------------------------------------------------------------
// per-block modifiers: integrity verify fill/check, rwmix read split, block
// variance refill — the reference runs all three INSIDE its native hot loop
// (LocalWorker.cpp:1741 rwmix modulo, :2124 verify fill, :2242 variance), so
// enabling them must not drop the loop out of native code.

constexpr uint64_t kGoldenPrime = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kVarReseedBytes = 256 * 1024;  // RandAlgoGoldenPrime.h:14

inline uint64_t splitmix64(uint64_t& s) {
    s += 0x9E3779B97F4A7C15ull;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

// golden-prime 'fast' tier PRNG for --blockvarpct buffer refills: weak
// multiplicative stream, reseeded from a strong source every 256 KiB
// (same structure as toolkits/random_algos.py RandAlgoGoldenPrime; the
// reseed source here is splitmix64 — content characteristics match, the
// exact stream is not part of any contract)
struct VarRng {
    uint64_t state;
    uint64_t reseed_state;
    uint64_t bytes_since = 0;

    explicit VarRng(uint64_t seed) : reseed_state(seed) {
        state = splitmix64(reseed_state) | 1;
    }

    inline uint64_t next64() {
        bytes_since += 8;
        if (bytes_since >= kVarReseedBytes) {
            state = splitmix64(reseed_state) | 1;
            bytes_since = 0;
        }
        state *= kGoldenPrime;
        return (state << 32) | (state >> 32);
    }

    // refill the first `pct`% of a block (preWriteBufRandRefill :2242)
    void refill(char* buf, uint64_t len, int pct) {
        const uint64_t refill_len = len * static_cast<uint64_t>(pct) / 100;
        uint64_t whole = refill_len / 8;
        char* p = buf;
        while (whole--) {
            const uint64_t v = next64();
            memcpy(p, &v, 8);
            p += 8;
        }
        const uint64_t tail = refill_len % 8;
        if (tail) {
            const uint64_t v = next64();
            memcpy(p, &v, tail);
        }
    }
};

// verify pattern: 8-byte word j of a block at file offset `off` holds
// (off + 8j + salt); tail bytes (len % 8) are zero — exactly the host-side
// pattern of workers/local_worker.py::_fill_verify_pattern (reference:
// preWriteIntegrityCheckFillBuf, LocalWorker.cpp:2124)
inline void verify_fill(char* buf, uint64_t off, uint64_t len,
                        uint64_t salt) {
    const uint64_t n_words = len / 8;
    for (uint64_t j = 0; j < n_words; ++j) {
        const uint64_t v = off + 8 * j + salt;
        memcpy(buf + 8 * j, &v, 8);
    }
    if (len % 8)
        memset(buf + n_words * 8, 0, len % 8);
}

// 0 on match; on mismatch fills info[] = {block_idx, word_idx, want, got}
// (postReadIntegrityCheckVerifyBuf :2170 — exact mismatch offset report)
inline int verify_check(const char* buf, uint64_t off, uint64_t len,
                        uint64_t salt, uint64_t block_idx, uint64_t* info) {
    const uint64_t n_words = len / 8;
    for (uint64_t j = 0; j < n_words; ++j) {
        const uint64_t want = off + 8 * j + salt;
        uint64_t got;
        memcpy(&got, buf + 8 * j, 8);
        if (got != want) {
            info[0] = block_idx;
            info[1] = j;
            info[2] = want;
            info[3] = got;
            return -EILSEQ;
        }
    }
    return 0;
}

// per-thread bytes/sec limiter state: 1-second token windows, sleep to
// the next boundary when the budget is exhausted (reference:
// RateLimiter.h:1-72; wired as funcRWRateLimiter in the hot loop,
// LocalWorker.cpp:1306-1361). State lives in caller-provided memory so
// the window survives chunked engine calls.
struct RateState {
    uint64_t window_start_usec;  // 0 = uninitialized
    uint64_t bytes_in_window;
};

inline void rate_wait(uint64_t bps, RateState* rs, uint64_t nbytes,
                      volatile int* interrupt_flag) {
    if (!bps || !rs)
        return;
    uint64_t now = now_usec();
    if (rs->window_start_usec == 0)
        rs->window_start_usec = now;
    const uint64_t elapsed = now - rs->window_start_usec;
    if (elapsed >= 1000000ull) {
        rs->window_start_usec = now;
        rs->bytes_in_window = 0;
    } else if (rs->bytes_in_window + nbytes > bps) {
        // sleep to the second boundary in slices so interrupts are
        // noticed (the Python limiter checks before each wait too)
        uint64_t remaining = 1000000ull - elapsed;
        while (remaining > 0) {
            if (interrupt_flag && *interrupt_flag)
                return;
            const uint64_t slice = remaining > 100000 ? 100000 : remaining;
            usleep(static_cast<useconds_t>(slice));
            remaining -= slice;
        }
        rs->window_start_usec = now_usec();
        rs->bytes_in_window = 0;
    }
    rs->bytes_in_window += nbytes;
}

// advisory POSIX record lock around one op (--flock range|full; same
// fcntl F_SETLKW semantics as toolkits/file_tk.FileRangeLock and the
// reference's FileTk flock templates)
inline int op_lock(int fd, int mode, bool is_read, uint64_t off,
                   uint64_t len, bool unlock) {
    struct flock fl;
    memset(&fl, 0, sizeof(fl));
    fl.l_type = unlock ? F_UNLCK : (is_read ? F_RDLCK : F_WRLCK);
    fl.l_whence = SEEK_SET;
    fl.l_start = (mode == 1) ? static_cast<off_t>(off) : 0;
    fl.l_len = (mode == 1) ? static_cast<off_t>(len) : 0;
    while (fcntl(fd, F_SETLKW, &fl) != 0) {
        if (errno != EINTR)  // retry stray signals like Python's lockf
            return -errno;
    }
    return 0;
}

// one JSONL post-op record (--opslog; same schema as
// toolkits/ops_logger.py and the reference's OpsLogger.cpp:62-100 —
// block loops write completion records with an empty entry name)
inline int ops_record(int fd, int use_lock, int rank, bool rd,
                      uint64_t off, uint64_t len) {
    timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    struct tm tmv;
    localtime_r(&ts.tv_sec, &tmv);
    char datebuf[24];
    strftime(datebuf, sizeof(datebuf), "%Y%m%dT%H%M%S", &tmv);
    char line[224];
    const int n = snprintf(
        line, sizeof(line),
        "{\"date\":\"%s.%09ld\",\"worker_rank\":%d,"
        "\"op_name\":\"%s\",\"entry_name\":\"\","
        "\"offset\":%llu,\"length\":%llu,"
        "\"is_finished\":true,\"is_error\":false}\n",
        datebuf, static_cast<long>(ts.tv_nsec), rank,
        rd ? "read" : "write", static_cast<unsigned long long>(off),
        static_cast<unsigned long long>(len));
    if (use_lock) {
        int lr;
        while ((lr = flock(fd, LOCK_EX)) < 0 && errno == EINTR)
            continue;
        if (lr < 0)  // writing unlocked could interleave torn records —
            return -errno;  // the exact corruption --opsloglock prevents
    }
    int ret = 0;
    ssize_t done = 0;
    while (done < n) {  // full-line writes: a torn record corrupts JSONL
        const ssize_t w = write(fd, line + done,
                                static_cast<size_t>(n - done));
        if (w < 0) {
            if (errno == EINTR)
                continue;
            ret = -errno;  // surface ENOSPC etc. like the Python logger
            break;
        }
        done += w;
    }
    if (use_lock)
        flock(fd, LOCK_UN);
    return ret;
}

// bundled modifier config threaded through all block loops; disabled
// members are no-ops so the plain path stays branch-light
struct BlockMod {
    const unsigned char* op_is_read = nullptr;  // rwmix: per-op read flag
    uint64_t verify_salt = 0;
    int do_verify = 0;
    int var_pct = 0;
    VarRng* var_rng = nullptr;
    uint64_t* verify_info = nullptr;  // out[4] on -EILSEQ
    uint64_t limit_read_bps = 0;
    uint64_t limit_write_bps = 0;
    RateState* rl_read = nullptr;
    RateState* rl_write = nullptr;
    int inline_readback = 0;  // --readinline/--verifydirect (sync only)
    int flock_mode = 0;       // --flock: 0 none, 1 range, 2 full (sync)
    int ops_fd = -1;          // --opslog trace fd (-1 = off)
    int ops_lock = 0;
    int worker_rank = 0;

    inline int log_op(bool rd, uint64_t off, uint64_t len) const {
        if (ops_fd < 0)
            return 0;
        return ops_record(ops_fd, ops_lock, worker_rank, rd, off, len);
    }

    inline bool op_reads(uint64_t i, int phase_is_write) const {
        return op_is_read ? (op_is_read[i] != 0) : !phase_is_write;
    }

    inline void rate_limit(bool rd, uint64_t len,
                           volatile int* interrupt_flag) const {
        if (rd)
            rate_wait(limit_read_bps, rl_read, len, interrupt_flag);
        else
            rate_wait(limit_write_bps, rl_write, len, interrupt_flag);
    }

    inline void pre_write(char* buf, uint64_t off, uint64_t len) const {
        if (do_verify)
            verify_fill(buf, off, len, verify_salt);
        else if (var_rng && var_pct)
            var_rng->refill(buf, len, var_pct);
    }

    inline int post_read(const char* buf, uint64_t off, uint64_t len,
                         uint64_t block_idx) const {
        if (!do_verify)
            return 0;
        return verify_check(buf, off, len, verify_salt, block_idx,
                            verify_info);
    }
};

// raw syscall wrappers (kernel AIO without libaio)
inline int sys_io_setup(unsigned nr, aio_context_t* ctx) {
    return static_cast<int>(syscall(SYS_io_setup, nr, ctx));
}
inline int sys_io_destroy(aio_context_t ctx) {
    return static_cast<int>(syscall(SYS_io_destroy, ctx));
}
inline int sys_io_submit(aio_context_t ctx, long n, iocb** iocbs) {
    return static_cast<int>(syscall(SYS_io_submit, ctx, n, iocbs));
}
inline int sys_io_getevents(aio_context_t ctx, long min_nr, long nr,
                            io_event* events, timespec* timeout) {
    return static_cast<int>(
        syscall(SYS_io_getevents, ctx, min_nr, nr, events, timeout));
}
inline int sys_io_cancel(aio_context_t ctx, iocb* cb, io_event* result) {
    return static_cast<int>(syscall(SYS_io_cancel, ctx, cb, result));
}

int run_sync_loop(const int* fds, const uint32_t* fd_idx,
                  const uint64_t* offsets, const uint64_t* lengths,
                  uint64_t n, int is_write, char* buf,
                  uint64_t* out_lat_usec, uint64_t* out_bytes,
                  volatile int* interrupt_flag, const BlockMod& mod) {
    uint64_t bytes_done = 0;
    for (uint64_t i = 0; i < n; ++i) {
        if ((i % kInterruptCheckInterval) == 0 && interrupt_flag
                && *interrupt_flag)
            break;
        const int fd = fds[fd_idx ? fd_idx[i] : 0];
        const uint64_t len = lengths[i];
        const uint64_t off = offsets[i];
        const bool is_read_op = mod.op_reads(i, is_write);
        mod.rate_limit(is_read_op, len, interrupt_flag);
        if (!is_read_op)
            mod.pre_write(buf, off, len);
        const uint64_t t0 = now_usec();
        if (mod.flock_mode) {  // lock wait counts as op latency (Python
                               // path stamps before the lock too)
            const int lret = op_lock(fd, mod.flock_mode, is_read_op, off,
                                     len, /*unlock=*/false);
            if (lret != 0)
                return lret;
        }
        ssize_t res = is_read_op
            ? pread(fd, buf, len, static_cast<off_t>(off))
            : pwrite(fd, buf, len, static_cast<off_t>(off));
        const int io_errno = res < 0 ? errno : 0;  // before unlock fcntl
        out_lat_usec[i] = now_usec() - t0;
        if (mod.flock_mode)
            op_lock(fd, mod.flock_mode, is_read_op, off, len,
                    /*unlock=*/true);
        if (res < 0)
            return -io_errno;
        if (static_cast<uint64_t>(res) != len)
            return -EIO;  // short read/write is an error, like the reference
        {
            const int lg = mod.log_op(is_read_op, off, len);
            if (lg != 0)
                return lg;
        }
        if (is_read_op) {
            const int vret = mod.post_read(buf, off, len, i);
            if (vret != 0)
                return vret;
        } else if (mod.inline_readback) {
            // --readinline/--verifydirect: read the block straight back
            // (outside the latency stamp, like pwriteAndReadWrapper and
            // the Python _inline_read_back)
            const ssize_t rres = pread(fd, buf, len,
                                       static_cast<off_t>(off));
            if (rres < 0)
                return -errno;
            if (static_cast<uint64_t>(rres) != len)
                return -EIO;
            const int vret = mod.post_read(buf, off, len, i);
            if (vret != 0)
                return vret;
        }
        bytes_done += static_cast<uint64_t>(res);
    }
    *out_bytes = bytes_done;
    return 0;
}

struct AioSlot {
    iocb cb;
    char* buf;
    uint64_t submit_usec;
    uint64_t block_idx;
};

int run_aio_loop(const int* fds, const uint32_t* fd_idx,
                 const uint64_t* offsets, const uint64_t* lengths,
                 uint64_t n, int is_write, const char* src_buf,
                 uint64_t buf_size, int iodepth, uint64_t* out_lat_usec,
                 uint64_t* out_bytes, volatile int* interrupt_flag,
                 const BlockMod& mod) {
    aio_context_t ctx = 0;
    if (sys_io_setup(static_cast<unsigned>(iodepth), &ctx) < 0)
        return -errno;

    AioSlot* slots = new AioSlot[iodepth];
    int ret = 0;
    int allocated = 0;
    for (; allocated < iodepth; ++allocated) {
        void* p = nullptr;
        if (posix_memalign(&p, kAlign, buf_size) != 0) {
            ret = -ENOMEM;
            break;
        }
        slots[allocated].buf = static_cast<char*>(p);
        // write payload: replicate the caller's (pre-randomized) buffer
        if (is_write)
            memcpy(slots[allocated].buf, src_buf, buf_size);
    }

    uint64_t next_submit = 0;   // next block index to submit
    uint64_t completed = 0;
    uint64_t bytes_done = 0;
    int in_flight = 0;

    if (ret == 0) {
        // seed phase: one submit at a time up to iodepth (reference
        // aioBlockSized seeds the ring the same way)
        while (in_flight < iodepth && next_submit < n) {
            AioSlot& s = slots[in_flight];
            const bool rd = mod.op_reads(next_submit, is_write);
            mod.rate_limit(rd, lengths[next_submit], interrupt_flag);
            if (!rd)
                mod.pre_write(s.buf, offsets[next_submit],
                              lengths[next_submit]);
            memset(&s.cb, 0, sizeof(s.cb));
            s.cb.aio_fildes = static_cast<uint32_t>(
                fds[fd_idx ? fd_idx[next_submit] : 0]);
            s.cb.aio_lio_opcode = rd ? IOCB_CMD_PREAD : IOCB_CMD_PWRITE;
            s.cb.aio_buf = reinterpret_cast<uint64_t>(s.buf);
            s.cb.aio_nbytes = lengths[next_submit];
            s.cb.aio_offset = static_cast<int64_t>(offsets[next_submit]);
            s.cb.aio_data = reinterpret_cast<uint64_t>(&s);
            s.submit_usec = now_usec();
            s.block_idx = next_submit;
            iocb* cbp = &s.cb;
            if (sys_io_submit(ctx, 1, &cbp) != 1) {
                ret = -errno;
                break;
            }
            ++next_submit;
            ++in_flight;
        }

        // completion + refill loop (bounded wait like the reference's 5s
        // io_getevents timeout so interrupts are noticed)
        io_event events[4];
        while (ret == 0 && completed < n) {
            if (interrupt_flag && *interrupt_flag)
                break;
            timespec timeout = {1, 0};
            int got = sys_io_getevents(ctx, 1, 4, events, &timeout);
            if (got < 0) {
                if (errno == EINTR)
                    continue;
                ret = -errno;
                break;
            }
            // pass 1: account every completion BEFORE any refill — the
            // refill's rate limiter may sleep, and stamping later
            // completions after that sleep would book limiter time as
            // device latency
            const uint64_t t_now = now_usec();
            // every reaped event is out of the kernel regardless of how
            // its processing below goes; decrementing per-event instead
            // would make an error break leave the teardown drain waiting
            // for completions that were already delivered
            in_flight -= got;
            AioSlot* free_slots[4];
            int n_free = 0;
            for (int e = 0; e < got; ++e) {
                AioSlot* s = reinterpret_cast<AioSlot*>(events[e].data);
                const int64_t res = events[e].res;
                if (res < 0) {
                    ret = static_cast<int>(res);
                    break;
                }
                if (static_cast<uint64_t>(res) != lengths[s->block_idx]) {
                    ret = -EIO;
                    break;
                }
                const bool was_read = mod.op_reads(s->block_idx, is_write);
                // log BEFORE verify so the read that detects corruption
                // appears in the trace (sync-loop and Python parity)
                ret = mod.log_op(was_read, offsets[s->block_idx],
                                 lengths[s->block_idx]);
                if (ret != 0)
                    break;
                if (was_read) {
                    ret = mod.post_read(s->buf, offsets[s->block_idx],
                                        lengths[s->block_idx], s->block_idx);
                    if (ret != 0)
                        break;
                }
                out_lat_usec[s->block_idx] = t_now - s->submit_usec;
                bytes_done += static_cast<uint64_t>(res);
                ++completed;
                free_slots[n_free++] = s;
            }
            // pass 2: refill the freed slots (rate limit + fill + submit)
            for (int f = 0; f < n_free && ret == 0; ++f) {
                if (next_submit >= n)
                    break;
                AioSlot* s = free_slots[f];
                const bool rd = mod.op_reads(next_submit, is_write);
                mod.rate_limit(rd, lengths[next_submit], interrupt_flag);
                if (!rd)
                    mod.pre_write(s->buf, offsets[next_submit],
                                  lengths[next_submit]);
                memset(&s->cb, 0, sizeof(s->cb));
                s->cb.aio_fildes = static_cast<uint32_t>(
                    fds[fd_idx ? fd_idx[next_submit] : 0]);
                s->cb.aio_lio_opcode =
                    rd ? IOCB_CMD_PREAD : IOCB_CMD_PWRITE;
                s->cb.aio_buf = reinterpret_cast<uint64_t>(s->buf);
                s->cb.aio_nbytes = lengths[next_submit];
                s->cb.aio_offset =
                    static_cast<int64_t>(offsets[next_submit]);
                s->cb.aio_data = reinterpret_cast<uint64_t>(s);
                s->submit_usec = now_usec();
                s->block_idx = next_submit;
                iocb* cbp = &s->cb;
                if (sys_io_submit(ctx, 1, &cbp) != 1) {
                    ret = -errno;
                    break;
                }
                ++next_submit;
                ++in_flight;
            }
        }
    }

    // drain remaining in-flight ops before teardown (interrupt/error path)
    while (in_flight > 0) {
        io_event events[4];
        timespec timeout = {1, 0};
        int got = sys_io_getevents(ctx, 1, 4, events, &timeout);
        if (got <= 0)
            break;
        in_flight -= got;
    }
    // destroy the context BEFORE freeing slot buffers: io_destroy blocks
    // until outstanding kernel DMA into those buffers has finished, so
    // freeing first would be a use-after-free on an interrupted chunk
    sys_io_destroy(ctx);
    for (int i = 0; i < allocated; ++i)
        free(slots[i].buf);
    delete[] slots;
    *out_bytes = bytes_done;
    return ret;
}

// ---------------------------------------------------------------------------
// io_uring path (raw syscalls; no liburing)

inline int sys_io_uring_setup(unsigned entries, io_uring_params* p) {
    return static_cast<int>(syscall(__NR_io_uring_setup, entries, p));
}
inline int sys_io_uring_enter(int ring_fd, unsigned to_submit,
                              unsigned min_complete, unsigned flags,
                              const void* arg, size_t argsz) {
    return static_cast<int>(syscall(__NR_io_uring_enter, ring_fd, to_submit,
                                    min_complete, flags, arg, argsz));
}
inline int sys_io_uring_register(int ring_fd, unsigned opcode,
                                 const void* arg, unsigned nr_args) {
    return static_cast<int>(syscall(__NR_io_uring_register, ring_fd, opcode,
                                    arg, nr_args));
}

// IORING_REGISTER_BUFFERS/_FILES, READ/WRITE_FIXED and IOSQE_FIXED_FILE
// are kernel-5.1 enums from linux/io_uring.h — as old as io_uring itself,
// so any header that compiles this file has them

#ifndef IORING_ENTER_EXT_ARG
#define IORING_ENTER_EXT_ARG (1U << 3)
#endif
#ifndef IORING_FEAT_EXT_ARG
#define IORING_FEAT_EXT_ARG (1U << 8)
#endif
#ifndef IORING_SETUP_SQPOLL
#define IORING_SETUP_SQPOLL (1U << 1)
#endif
#ifndef IORING_SQ_NEED_WAKEUP
#define IORING_SQ_NEED_WAKEUP (1U << 0)
#endif
#ifndef IORING_ENTER_SQ_WAKEUP
#define IORING_ENTER_SQ_WAKEUP (1U << 1)
#endif

// defined locally in case the image's linux/io_uring.h predates 5.11
struct UringGetEventsArg {
    uint64_t sigmask;
    uint32_t sigmask_sz;
    uint32_t pad;
    uint64_t ts;
};

struct UringSlot {
    char* buf;
    uint64_t submit_usec;
    uint64_t block_idx;
    uint16_t buf_index;  // registered-buffer slot for READ/WRITE_FIXED
};

// mmap'd ring state; unmap-all on destruction
struct UringRings {
    int ring_fd = -1;
    void* sq_ptr = nullptr;
    void* cq_ptr = nullptr;
    io_uring_sqe* sqes = nullptr;
    size_t sq_sz = 0, cq_sz = 0, sqes_sz = 0;
    // ring pointers (into sq_ptr/cq_ptr)
    unsigned* sq_tail = nullptr;
    unsigned* sq_mask = nullptr;
    unsigned* sq_array = nullptr;
    unsigned* cq_head = nullptr;
    unsigned* cq_tail = nullptr;
    unsigned* cq_mask = nullptr;
    io_uring_cqe* cqes = nullptr;
    // SQPOLL additions (ABI 11): the kernel-consumed SQ head (space
    // check — with a polling thread the SQ drains asynchronously, so
    // the producer must not overwrite unconsumed SQEs) and the SQ flags
    // word (IORING_SQ_NEED_WAKEUP when the idle thread went to sleep)
    unsigned* sq_khead = nullptr;
    unsigned* sq_kflags = nullptr;
    unsigned sq_entries = 0;
    bool sqpoll = false;

    ~UringRings() { reset(); }

    // unmap/close everything and return to the freshly-constructed
    // state — also the cleanup between init() attempts (a partially
    // successful init may leave the ring fd open and some rings mapped;
    // re-initializing over them would leak fd + mappings)
    void reset() {
        if (sqes)
            munmap(sqes, sqes_sz);
        if (cq_ptr && cq_ptr != sq_ptr)
            munmap(cq_ptr, cq_sz);
        if (sq_ptr)
            munmap(sq_ptr, sq_sz);
        if (ring_fd >= 0)
            close(ring_fd);
        ring_fd = -1;
        sq_ptr = cq_ptr = nullptr;
        sqes = nullptr;
        sq_sz = cq_sz = sqes_sz = 0;
        sq_tail = sq_mask = sq_array = nullptr;
        cq_head = cq_tail = cq_mask = nullptr;
        cqes = nullptr;
        sq_khead = sq_kflags = nullptr;
        sq_entries = 0;
        sqpoll = false;
    }

    int init(unsigned entries, unsigned setup_flags = 0,
             unsigned sq_thread_idle_ms = 0) {
        io_uring_params p;
        memset(&p, 0, sizeof(p));
        p.flags = setup_flags;
        if (setup_flags & IORING_SETUP_SQPOLL)
            p.sq_thread_idle = sq_thread_idle_ms;
        ring_fd = sys_io_uring_setup(entries, &p);
        if (ring_fd < 0)
            return -errno;
        sqpoll = (setup_flags & IORING_SETUP_SQPOLL) != 0;
        // the bounded-wait loops need EXT_ARG timeouts (5.11+); without
        // them a blocking GETEVENTS could never notice interrupts
        if (!(p.features & IORING_FEAT_EXT_ARG))
            return -ENOSYS;
        sq_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
        cq_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
        const bool single_mmap = p.features & IORING_FEAT_SINGLE_MMAP;
        if (single_mmap)
            sq_sz = cq_sz = (sq_sz > cq_sz ? sq_sz : cq_sz);
        sq_ptr = mmap(nullptr, sq_sz, PROT_READ | PROT_WRITE,
                      MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQ_RING);
        if (sq_ptr == MAP_FAILED) {
            sq_ptr = nullptr;
            return -errno;
        }
        if (single_mmap) {
            cq_ptr = sq_ptr;
        } else {
            cq_ptr = mmap(nullptr, cq_sz, PROT_READ | PROT_WRITE,
                          MAP_SHARED | MAP_POPULATE, ring_fd,
                          IORING_OFF_CQ_RING);
            if (cq_ptr == MAP_FAILED) {
                cq_ptr = nullptr;
                return -errno;
            }
        }
        sqes_sz = p.sq_entries * sizeof(io_uring_sqe);
        void* sq_mem = mmap(nullptr, sqes_sz, PROT_READ | PROT_WRITE,
                            MAP_SHARED | MAP_POPULATE, ring_fd,
                            IORING_OFF_SQES);
        if (sq_mem == MAP_FAILED)
            return -errno;
        sqes = static_cast<io_uring_sqe*>(sq_mem);
        char* sq = static_cast<char*>(sq_ptr);
        char* cq = static_cast<char*>(cq_ptr);
        sq_tail = reinterpret_cast<unsigned*>(sq + p.sq_off.tail);
        sq_mask = reinterpret_cast<unsigned*>(sq + p.sq_off.ring_mask);
        sq_array = reinterpret_cast<unsigned*>(sq + p.sq_off.array);
        cq_head = reinterpret_cast<unsigned*>(cq + p.cq_off.head);
        cq_tail = reinterpret_cast<unsigned*>(cq + p.cq_off.tail);
        cq_mask = reinterpret_cast<unsigned*>(cq + p.cq_off.ring_mask);
        cqes = reinterpret_cast<io_uring_cqe*>(cq + p.cq_off.cqes);
        sq_khead = reinterpret_cast<unsigned*>(sq + p.sq_off.head);
        sq_kflags = reinterpret_cast<unsigned*>(sq + p.sq_off.flags);
        sq_entries = p.sq_entries;
        return 0;
    }

    // SQ space check for async (SQPOLL) submission: true when writing
    // one more SQE would overwrite an entry the polling thread has not
    // consumed yet. Without SQPOLL the synchronous enter drains the SQ
    // before this can trip (slot discipline bounds queued <= entries).
    bool sq_full() const {
        return *sq_tail - __atomic_load_n(sq_khead, __ATOMIC_ACQUIRE)
            >= sq_entries;
    }

    // make queued SQEs visible to the kernel. Non-SQPOLL: one enter
    // syscall, returns the number consumed. SQPOLL: the polling thread
    // consumes asynchronously — no syscall at all unless the idle
    // thread went to sleep (NEED_WAKEUP), and the full queued count is
    // reported consumed (the slot discipline guarantees SQ capacity).
    int flush_submissions(unsigned queued) {
        if (!sqpoll) {
            int res;
            do {
                res = sys_io_uring_enter(ring_fd, queued, 0, 0, nullptr, 0);
            } while (res < 0 && errno == EINTR);
            return res < 0 ? -errno : res;
        }
        if (__atomic_load_n(sq_kflags, __ATOMIC_ACQUIRE)
                & IORING_SQ_NEED_WAKEUP) {
            int res;
            do {
                res = sys_io_uring_enter(ring_fd, 0, 0,
                                         IORING_ENTER_SQ_WAKEUP, nullptr,
                                         0);
            } while (res < 0 && errno == EINTR);
            if (res < 0)
                return -errno;
        }
        return static_cast<int>(queued);
    }
};

// ---------------------------------------------------------------------------
// registered-buffer staging pool (ABI 11): a PERSISTENT io_uring whose
// fixed-buffer table is the worker's staging-pool slab, registered once
// at pool open and shared by the classic block loop
// (ioengine_run_block_loop5) and the streaming producer mode
// (ioengine_stream_open_pooled) — today's per-call/per-context
// registration pays a get_user_pages pin + unpin on every ring
// lifetime; the pool pays it once per worker. Optionally SQPOLL
// (kernel submission-queue polling thread, idle-timeout configurable):
// submission becomes a published SQ-tail store, no io_uring_enter on
// the hot path at all unless the idle thread went to sleep.

enum {
    POOL_FEAT_URING = 1 << 0,       // persistent ring exists
    POOL_FEAT_FIXED_BUFFERS = 1 << 1,  // slab registered as fixed buffers
    POOL_FEAT_SQPOLL = 1 << 2,      // SQPOLL thread active
};

struct PoolCtx {
    UringRings ring;
    uint64_t* slot_addrs = nullptr;
    uint64_t n_slots = 0;
    uint64_t slot_size = 0;
    bool fixed_buffers = false;
    bool stream_active = false;  // a pooled stream currently owns the ring

    ~PoolCtx() { delete[] slot_addrs; }
};

int run_uring_loop(const int* fds, const uint32_t* fd_idx,
                   const uint64_t* offsets, const uint64_t* lengths,
                   uint64_t n, int is_write, const char* src_buf,
                   uint64_t buf_size, int iodepth, uint64_t* out_lat_usec,
                   uint64_t* out_bytes, volatile int* interrupt_flag,
                   const BlockMod& mod) {
    if (iodepth < 1)
        iodepth = 1;
    UringRings ring;
    int ret = ring.init(static_cast<unsigned>(iodepth));
    if (ret != 0)
        return ret;

    UringSlot* slots = new UringSlot[iodepth];
    for (int i = 0; i < iodepth; ++i)
        slots[i].buf = nullptr;
    int allocated = 0;
    for (; allocated < iodepth; ++allocated) {
        void* p = nullptr;
        if (posix_memalign(&p, kAlign, buf_size) != 0) {
            ret = -ENOMEM;
            break;
        }
        slots[allocated].buf = static_cast<char*>(p);
        slots[allocated].buf_index = static_cast<uint16_t>(allocated);
        if (is_write)
            memcpy(slots[allocated].buf, src_buf, buf_size);
    }

    // register the slot buffers (pages stay pinned: no per-op
    // get_user_pages) and the fd table (no per-op fget/fput). Both are
    // pure fast-path optimizations — EPERM/ENOMEM (e.g. RLIMIT_MEMLOCK)
    // just falls back to the unregistered opcodes.
    bool fixed_buffers = false;
    bool fixed_files = false;
    uint32_t n_fds = 1;
    if (ret == 0 && allocated == iodepth) {
        iovec* iov = new iovec[iodepth];
        for (int i = 0; i < iodepth; ++i) {
            iov[i].iov_base = slots[i].buf;
            iov[i].iov_len = buf_size;
        }
        fixed_buffers = sys_io_uring_register(
            ring.ring_fd, IORING_REGISTER_BUFFERS, iov, iodepth) == 0;
        delete[] iov;
        if (fd_idx)
            for (uint64_t i = 0; i < n; ++i)
                if (fd_idx[i] >= n_fds)
                    n_fds = fd_idx[i] + 1;
        fixed_files = sys_io_uring_register(
            ring.ring_fd, IORING_REGISTER_FILES, fds, n_fds) == 0;
    }

    uint64_t next_submit = 0;
    uint64_t completed = 0;
    uint64_t bytes_done = 0;
    int queued = 0;     // SQEs written to the ring but not yet submitted
    int in_flight = 0;  // ops the kernel owns (submitted, not yet reaped) —
                        // ONLY these can DMA into slot buffers
    // slots queued since the last enter: their submit stamps are refreshed
    // right before the enter so rate-limiter sleeps between queue_one
    // calls never count as device latency
    UringSlot** pending = new UringSlot*[iodepth];
    int n_pending = 0;
    // completions reaped per pass before their slots are refilled; sized
    // to the ring (cq depth can reach 2x sq, but never more slots exist
    // than iodepth)
    UringSlot** freed = new UringSlot*[iodepth];

    // queue one block on a free slot; sq tail advance is published with a
    // release store (kernel reads it with acquire semantics)
    auto queue_one = [&](UringSlot& s) {
        const bool rd = mod.op_reads(next_submit, is_write);
        mod.rate_limit(rd, lengths[next_submit], interrupt_flag);
        if (!rd)
            mod.pre_write(s.buf, offsets[next_submit], lengths[next_submit]);
        const unsigned tail = *ring.sq_tail;
        const unsigned idx = tail & *ring.sq_mask;
        io_uring_sqe* sqe = &ring.sqes[idx];
        memset(sqe, 0, sizeof(*sqe));
        if (fixed_buffers) {
            sqe->opcode = rd ? IORING_OP_READ_FIXED : IORING_OP_WRITE_FIXED;
            sqe->buf_index = s.buf_index;
        } else {
            sqe->opcode = rd ? IORING_OP_READ : IORING_OP_WRITE;
        }
        if (fixed_files) {
            sqe->fd = static_cast<int32_t>(fd_idx ? fd_idx[next_submit] : 0);
            sqe->flags |= IOSQE_FIXED_FILE;
        } else {
            sqe->fd = fds[fd_idx ? fd_idx[next_submit] : 0];
        }
        sqe->addr = reinterpret_cast<uint64_t>(s.buf);
        sqe->len = static_cast<uint32_t>(lengths[next_submit]);
        sqe->off = offsets[next_submit];
        sqe->user_data = reinterpret_cast<uint64_t>(&s);
        ring.sq_array[idx] = idx;
        s.submit_usec = now_usec();
        s.block_idx = next_submit;
        __atomic_store_n(ring.sq_tail, tail + 1, __ATOMIC_RELEASE);
        ++next_submit;
        ++queued;
        pending[n_pending++] = &s;
    };

    if (ret == 0) {
        // seed the ring up to iodepth
        while (queued < iodepth && next_submit < n)
            queue_one(slots[queued]);

        while (ret == 0 && completed < n) {
            if (interrupt_flag && *interrupt_flag)
                break;
            // submit anything queued and wait (bounded, for interrupts)
            timespec ts = {1, 0};
            UringGetEventsArg arg;
            memset(&arg, 0, sizeof(arg));
            arg.ts = reinterpret_cast<uint64_t>(&ts);
            // the queued SQEs only reach the kernel NOW: refresh their
            // stamps (queue_one may have slept in the rate limiter since)
            const uint64_t t_enter = now_usec();
            for (int q = 0; q < n_pending; ++q)
                pending[q]->submit_usec = t_enter;
            n_pending = 0;
            int res = sys_io_uring_enter(
                ring.ring_fd, static_cast<unsigned>(queued), 1,
                IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG, &arg,
                sizeof(arg));
            if (res < 0 && errno != ETIME) {
                if (errno == EINTR)
                    continue;
                ret = -errno;
                break;
            }
            if (res > 0) {  // enter returns the number of SQEs consumed
                in_flight += res;
                queued -= res;
            }
            // reap completions (pass 1: account — no refill sleeps may
            // land between a completion and its latency stamp)
            unsigned head = *ring.cq_head;
            const unsigned tail =
                __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
            const uint64_t t_now = now_usec();
            int n_freed = 0;
            while (head != tail && ret == 0) {
                const io_uring_cqe& cqe = ring.cqes[head & *ring.cq_mask];
                UringSlot* s = reinterpret_cast<UringSlot*>(cqe.user_data);
                ++head;
                --in_flight;  // every reaped cqe leaves the ring, error or not
                const bool was_read = mod.op_reads(s->block_idx, is_write);
                if (cqe.res < 0) {
                    ret = cqe.res;
                } else if (static_cast<uint64_t>(cqe.res)
                           != lengths[s->block_idx]) {
                    ret = -EIO;
                } else if ((ret = mod.log_op(was_read,
                                             offsets[s->block_idx],
                                             lengths[s->block_idx]))
                           != 0) {
                    // opslog write failed (e.g. ENOSPC): fail the run
                    // like the Python logger's os.write would
                } else if (was_read
                           && (ret = mod.post_read(
                                   s->buf, offsets[s->block_idx],
                                   lengths[s->block_idx], s->block_idx))
                              != 0) {
                    // verify mismatch: ret carries -EILSEQ, info[] is set
                } else {
                    out_lat_usec[s->block_idx] = t_now - s->submit_usec;
                    bytes_done += static_cast<uint64_t>(cqe.res);
                    ++completed;
                    freed[n_freed++] = s;  // <= iodepth slots exist
                }
            }
            __atomic_store_n(ring.cq_head, head, __ATOMIC_RELEASE);
            // pass 2: refill freed slots (rate limit + fill + queue)
            for (int f = 0; f < n_freed && ret == 0; ++f)
                if (next_submit < n)
                    queue_one(*freed[f]);
        }
    }

    // drain in-flight ops before buffers are freed (interrupt/error path):
    // the kernel may still be DMA-ing into slot buffers, so we must wait
    // for every outstanding completion however long it takes — freeing
    // early would be a use-after-free. Only an unrecoverable enter error
    // aborts the drain, and then the slot buffers are deliberately leaked.
    bool drain_failed = false;
    while (in_flight > 0) {
        unsigned head = *ring.cq_head;
        const unsigned tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
        if (head == tail) {
            timespec ts = {1, 0};
            UringGetEventsArg arg;
            memset(&arg, 0, sizeof(arg));
            arg.ts = reinterpret_cast<uint64_t>(&ts);
            if (sys_io_uring_enter(
                    ring.ring_fd, 0, 1,
                    IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG,
                    &arg, sizeof(arg)) < 0
                    && errno != ETIME && errno != EINTR) {
                drain_failed = true;
                break;
            }
            continue;
        }
        while (head != tail) {
            ++head;
            --in_flight;
        }
        __atomic_store_n(ring.cq_head, head, __ATOMIC_RELEASE);
    }
    if (!drain_failed)
        for (int i = 0; i < allocated; ++i)
            free(slots[i].buf);
    delete[] pending;
    delete[] freed;
    delete[] slots;
    *out_bytes = bytes_done;
    return ret;
}

// classic block loop over the POOL's persistent ring (ABI 11): same
// seed/refill/latency semantics as run_uring_loop, but no ring setup, no
// per-call buffer allocation and no per-call registration — the ops run
// READ/WRITE_FIXED against the pool slab registered once at pool open.
// out_pool_stats (3 uint64, caller-zeroed): [0] ops completed with fixed
// buffers, [1] ops submitted without a synchronous enter (SQPOLL),
// [2] 1 when the teardown drain failed — the kernel may still own ops
// targeting pool slots, so the caller MUST stop using the pool and keep
// the slab mapped for the life of the process.
int run_pool_uring_loop(PoolCtx* pool, const int* fds,
                        const uint32_t* fd_idx, const uint64_t* offsets,
                        const uint64_t* lengths, uint64_t n, int is_write,
                        const char* src_buf, uint64_t buf_size, int iodepth,
                        uint64_t* out_lat_usec, uint64_t* out_bytes,
                        volatile int* interrupt_flag, const BlockMod& mod,
                        uint64_t* out_pool_stats) {
    UringRings& ring = pool->ring;
    if (iodepth < 1)
        iodepth = 1;
    if (static_cast<uint64_t>(iodepth) > pool->n_slots)
        iodepth = static_cast<int>(pool->n_slots);
    if (buf_size > pool->slot_size)
        return -EINVAL;  // an op would overrun its registered slot

    UringSlot* slots = new UringSlot[iodepth];
    for (int i = 0; i < iodepth; ++i) {
        slots[i].buf = reinterpret_cast<char*>(pool->slot_addrs[i]);
        slots[i].buf_index = static_cast<uint16_t>(i);
        // write payload: replicate the caller's (pre-randomized) buffer
        // into the other slots — the caller's buffer IS slot 0 of the
        // pool, so that one is already in place
        if (is_write && slots[i].buf != src_buf)
            memcpy(slots[i].buf, src_buf, buf_size);
    }

    uint64_t next_submit = 0;
    uint64_t completed = 0;
    uint64_t bytes_done = 0;
    int queued = 0;
    int in_flight = 0;
    int ret = 0;
    UringSlot** pending = new UringSlot*[iodepth];
    int n_pending = 0;
    UringSlot** freed = new UringSlot*[iodepth];

    auto queue_one = [&](UringSlot& s) {
        const bool rd = mod.op_reads(next_submit, is_write);
        mod.rate_limit(rd, lengths[next_submit], interrupt_flag);
        if (!rd)
            mod.pre_write(s.buf, offsets[next_submit], lengths[next_submit]);
        const unsigned tail = *ring.sq_tail;
        const unsigned idx = tail & *ring.sq_mask;
        io_uring_sqe* sqe = &ring.sqes[idx];
        memset(sqe, 0, sizeof(*sqe));
        if (pool->fixed_buffers) {
            sqe->opcode = rd ? IORING_OP_READ_FIXED : IORING_OP_WRITE_FIXED;
            sqe->buf_index = s.buf_index;
        } else {
            sqe->opcode = rd ? IORING_OP_READ : IORING_OP_WRITE;
        }
        sqe->fd = fds[fd_idx ? fd_idx[next_submit] : 0];
        sqe->addr = reinterpret_cast<uint64_t>(s.buf);
        sqe->len = static_cast<uint32_t>(lengths[next_submit]);
        sqe->off = offsets[next_submit];
        sqe->user_data = reinterpret_cast<uint64_t>(&s);
        ring.sq_array[idx] = idx;
        s.submit_usec = now_usec();
        s.block_idx = next_submit;
        __atomic_store_n(ring.sq_tail, tail + 1, __ATOMIC_RELEASE);
        ++next_submit;
        ++queued;
        pending[n_pending++] = &s;
    };

    // seed the window up to iodepth
    while (queued < iodepth && next_submit < n)
        queue_one(slots[queued]);

    while (ret == 0 && completed < n) {
        if (interrupt_flag && *interrupt_flag)
            break;
        if (queued) {
            // non-SQPOLL: refresh pending stamps right before the enter
            // (rate-limiter sleeps between queue_one calls must not book
            // as device latency). SQPOLL: the polling thread may already
            // be mid-DMA on these ops — the queue-time stamp is the
            // honest submit time, so keep it.
            if (!ring.sqpoll) {
                const uint64_t t_enter = now_usec();
                for (int q = 0; q < n_pending; ++q)
                    pending[q]->submit_usec = t_enter;
            } else if (out_pool_stats) {
                out_pool_stats[1] += static_cast<uint64_t>(queued);
            }
            n_pending = 0;
            const int res = ring.flush_submissions(
                static_cast<unsigned>(queued));
            if (res < 0) {
                ret = res;
                break;
            }
            in_flight += res;
            queued -= res;
        }
        // wait for at least one completion (bounded, interruptible)
        unsigned head = *ring.cq_head;
        unsigned tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
        if (head == tail) {
            timespec ts = {1, 0};
            UringGetEventsArg arg;
            memset(&arg, 0, sizeof(arg));
            arg.ts = reinterpret_cast<uint64_t>(&ts);
            if (sys_io_uring_enter(
                    ring.ring_fd, 0, 1,
                    IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG, &arg,
                    sizeof(arg)) < 0
                    && errno != ETIME && errno != EINTR) {
                ret = -errno;
                break;
            }
            tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
        }
        const uint64_t t_now = now_usec();
        int n_freed = 0;
        while (head != tail && ret == 0) {
            const io_uring_cqe& cqe = ring.cqes[head & *ring.cq_mask];
            UringSlot* s = reinterpret_cast<UringSlot*>(cqe.user_data);
            ++head;
            --in_flight;
            const bool was_read = mod.op_reads(s->block_idx, is_write);
            if (cqe.res < 0) {
                ret = cqe.res;
            } else if (static_cast<uint64_t>(cqe.res)
                       != lengths[s->block_idx]) {
                ret = -EIO;
            } else if ((ret = mod.log_op(was_read, offsets[s->block_idx],
                                         lengths[s->block_idx])) != 0) {
                // opslog write failed: fail the run like the sync loop
            } else if (was_read
                       && (ret = mod.post_read(
                               s->buf, offsets[s->block_idx],
                               lengths[s->block_idx], s->block_idx))
                          != 0) {
                // verify mismatch: ret carries -EILSEQ, info[] is set
            } else {
                out_lat_usec[s->block_idx] = t_now - s->submit_usec;
                bytes_done += static_cast<uint64_t>(cqe.res);
                ++completed;
                if (out_pool_stats && pool->fixed_buffers)
                    ++out_pool_stats[0];
                freed[n_freed++] = s;
            }
        }
        __atomic_store_n(ring.cq_head, head, __ATOMIC_RELEASE);
        for (int f = 0; f < n_freed && ret == 0; ++f)
            if (next_submit < n)
                queue_one(*freed[f]);
    }

    // drain outstanding kernel DMA into the POOL slots before returning:
    // the caller will reuse them immediately (-EIO on an unrecoverable
    // wait error; the Python side then leaks the pool slab like a failed
    // stream drain, see StagingPool.leak)
    bool drain_failed = false;
    while (in_flight > 0 || queued > 0) {
        if (queued > 0) {
            // published-but-unconsumed SQEs must reach the kernel (or the
            // ring's next use would submit them in place of new ops)
            const int res = ring.flush_submissions(
                static_cast<unsigned>(queued));
            if (res < 0) {
                drain_failed = true;
                break;
            }
            in_flight += res;
            queued -= res;
        }
        unsigned head = *ring.cq_head;
        const unsigned tail = __atomic_load_n(ring.cq_tail,
                                              __ATOMIC_ACQUIRE);
        if (head == tail) {
            timespec ts = {1, 0};
            UringGetEventsArg arg;
            memset(&arg, 0, sizeof(arg));
            arg.ts = reinterpret_cast<uint64_t>(&ts);
            if (sys_io_uring_enter(
                    ring.ring_fd, 0, 1,
                    IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG,
                    &arg, sizeof(arg)) < 0
                    && errno != ETIME && errno != EINTR) {
                drain_failed = true;
                break;
            }
            continue;
        }
        while (head != tail) {
            ++head;
            --in_flight;
        }
        __atomic_store_n(ring.cq_head, head, __ATOMIC_RELEASE);
    }
    if (drain_failed && out_pool_stats)
        out_pool_stats[2] = 1;
    delete[] pending;
    delete[] freed;
    delete[] slots;
    *out_bytes = bytes_done;
    return ret;
}

// ---------------------------------------------------------------------------
// streaming producer mode (fused storage<->HBM loop): instead of running a
// whole block loop to completion, the engine exposes an io_uring
// submission/completion ring over the worker's REGISTERED staging slots.
// Python submits one read/write per slot, reaps completed slots (GIL
// released for the whole blocking wait — ctypes drops it around the call),
// and hands each completed slot straight to the TPU transfer pipeline
// (TpuWorkerContext.host_to_device / device_to_host), so disk DMA in the
// kernel overlaps HBM DMA dispatch in Python. This is the cuFileRead
// overlap shape of the reference's GPUDirect path (LocalWorker.cpp:
// 2633-2749) rebuilt on io_uring + PjRt.
//
// Contract: a slot holds AT MOST one in-flight op (submit returns -EBUSY
// otherwise); the caller owns the slot buffers and must keep them mapped
// until ioengine_stream_close returned (close drains outstanding kernel
// DMA first). Latency/length reporting matches run_block_loop4: per-op
// usec stamped submit -> reap-harvest, cqe res returned raw so short
// reads/writes surface to the caller.
//
// Backend tiers: io_uring (registered buffers/files, the primary path)
// with a kernel-AIO fallback on kernels without io_uring/EXT_ARG — the
// same async submit/reap semantics either way, so the Python fused loop
// is backend-agnostic and only ever falls back to the pure-Python loop
// when NEITHER async engine exists.

// deterministic fault-injection kinds (ioengine_stream_set_fault; TEST
// ONLY — the Python side refuses the env knob outside a test harness)
enum {
    STREAM_FAULT_NONE = 0,
    STREAM_FAULT_EIO = 1,        // completed op's result replaced by -EIO
    STREAM_FAULT_SHORT = 2,      // completed op's result halved (short r/w)
    STREAM_FAULT_HANG = 3,       // op never submitted to the kernel: it
                                 // only completes via deadline/cancel
};

// user_data tag of ASYNC_CANCEL SQEs so their CQEs are never mistaken
// for data-op completions (and never decrement in_flight)
constexpr uint64_t kStreamCancelTag = 0x8000000000000000ull;
constexpr uint8_t kOpAsyncCancel = 14;  // IORING_OP_ASYNC_CANCEL (5.5+)

// data-op user_data: (generation << 32) | slot. The generation makes
// cancellation race-free across slot re-arm: a stale ASYNC_CANCEL still
// queued when the slot's NEXT op is submitted targets the OLD
// generation's user_data and finds nothing — without it, the cancel
// would kill the new (healthy) op and surface a spurious -ECANCELED.
inline uint64_t stream_user_data(uint32_t slot, uint32_t gen) {
    return (static_cast<uint64_t>(gen & 0x7FFFFFFFu) << 32) | slot;
}

struct StreamSlotState {
    uint64_t submit_usec = 0;
    uint64_t expected_len = 0;
    int pending = 0;  // one in-flight op per slot, enforced
    uint32_t gen = 0;       // bumped per submit; see stream_user_data
    int fault_kind = STREAM_FAULT_NONE;  // injected fault of THIS op
    int kernel_owned = 0;   // a real kernel op is in flight for the slot
    int cancel_sent = 0;    // cancellation was issued for this op
    int deadline_hit = 0;   // cancellation came from --iotimeout expiry
    int synth_pending = 0;  // synthetic completion queued for next reap
    int64_t synth_res = 0;
};

struct StreamCtx {
    bool use_uring = false;
    UringRings ring;           // owned io_uring backend
    PoolCtx* pool = nullptr;   // borrowed persistent pool ring (ABI 11):
                               // buffers registered once at pool open,
                               // the ring survives this stream's close
    aio_context_t aio_ctx = 0; // kernel-AIO fallback backend
    iocb* aio_cbs = nullptr;   // one control block per slot
    StreamSlotState* slots = nullptr;
    uint64_t* slot_addrs = nullptr;
    uint64_t n_slots = 0;
    uint64_t slot_size = 0;
    int* fds = nullptr;
    uint32_t n_fds = 0;
    bool fixed_buffers = false;
    bool fixed_files = false;
    int in_flight = 0;
    // per-op deadline (--iotimeout; 0 = none): reap cancels ops older
    // than this and surfaces them as -ETIMEDOUT with the slot re-armed
    uint64_t op_timeout_usec = 0;
    // deterministic fault injection (seed, every_n, kind): op k is
    // faulted when every_n && (k + seed) % every_n == 0, counted at
    // submit so the schedule is independent of completion order
    uint64_t fault_seed = 0;
    uint64_t fault_every_n = 0;
    int fault_kind = STREAM_FAULT_NONE;
    uint64_t submit_counter = 0;
    int cancel_inflight = 0;   // outstanding ASYNC_CANCEL SQEs (uring)

    // the ring every uring operation goes through: the borrowed pool
    // ring when attached, else the stream's own
    UringRings& rings() { return pool ? pool->ring : ring; }

    ~StreamCtx() {
        if (aio_ctx)
            sys_io_destroy(aio_ctx);
        delete[] aio_cbs;
        delete[] slots;
        delete[] slot_addrs;
        delete[] fds;
    }
};

// ---------------------------------------------------------------------------
// dir-mode file loop: open -> write/read blocks -> close per file (LOSF
// hot path; reference: dirModeIterateFiles, LocalWorker.cpp:3055-3281 with
// unlinkat/fstatat for the delete/stat phases)

enum {
    FILE_OP_WRITE = 0,
    FILE_OP_READ = 1,
    FILE_OP_STAT = 2,
    FILE_OP_UNLINK = 3,
};

// per-block modifiers for the file loop: rwmix decided by the in-loop
// modulo (rank + ops submitted so far, continuing across chunk calls via
// rwmix_base) since block indices are implicit here, unlike the flag
// array of the block loops
struct FileLoopMod {
    uint64_t verify_salt = 0;
    int inline_readback = 0;
    int flock_mode = 0;
    uint64_t limit_read_bps = 0;
    uint64_t limit_write_bps = 0;
    RateState* rl_read = nullptr;
    RateState* rl_write = nullptr;
    int do_verify = 0;
    int var_pct = 0;
    VarRng* var_rng = nullptr;
    int rwmix_pct = 0;          // only meaningful for FILE_OP_WRITE
    uint64_t rwmix_base = 0;    // workerRank + numIOPSSubmitted at entry
    uint64_t* verify_info = nullptr;  // out[4] on -EILSEQ
    uint64_t* out_rwmix_blocks = nullptr;
    uint64_t* out_rwmix_bytes = nullptr;
};

int run_file_loop(const char* paths_blob, const uint32_t* path_offs,
                  uint64_t n_files, int op, int open_flags,
                  uint64_t file_size, uint64_t block_size, char* buf,
                  const uint64_t* range_starts, const uint64_t* range_lens,
                  int ignore_delete_errors, uint64_t* out_entry_lat,
                  uint64_t* out_block_lat, uint64_t* out_bytes,
                  uint64_t* out_entries, uint64_t* out_fail_idx,
                  volatile int* interrupt_flag, const FileLoopMod& mod) {
    uint64_t bytes_done = 0;
    uint64_t entries_done = 0;
    uint64_t block_idx = 0;
    uint64_t rwmix_blocks = 0;
    uint64_t rwmix_bytes = 0;

    for (uint64_t i = 0; i < n_files; ++i) {
        if (interrupt_flag && *interrupt_flag)
            break;
        const char* path = paths_blob + path_offs[i];
        // per-file byte range (custom-tree slices); default [0, file_size)
        const uint64_t r_start = range_starts ? range_starts[i] : 0;
        const uint64_t r_len = range_lens ? range_lens[i] : file_size;
        const uint64_t t_entry = now_usec();

        *out_fail_idx = i;  // pre-set: any error below names file i
        if (op == FILE_OP_STAT) {
            struct stat st;
            if (stat(path, &st) != 0)
                return -errno;
        } else if (op == FILE_OP_UNLINK) {
            if (unlink(path) != 0) {
                if (!(errno == ENOENT && ignore_delete_errors))
                    return -errno;
            }
        } else {
            const int fd = open(path, open_flags, 0644);
            if (fd < 0)
                return -errno;
            uint64_t off = r_start;
            const uint64_t r_end = r_start + r_len;
            uint64_t file_blocks = block_size
                ? (r_len + block_size - 1) / block_size : 0;
            while (file_blocks--) {
                const uint64_t len = (off + block_size <= r_end)
                    ? block_size : (r_end - off);
                // rwmix per-op split within the write phase (reference:
                // (rank+numIOPSSubmitted)%100 < pct, LocalWorker.cpp:1741)
                const bool rd = (op == FILE_OP_READ)
                    || (mod.rwmix_pct
                        && ((mod.rwmix_base + block_idx) % 100)
                           < static_cast<uint64_t>(mod.rwmix_pct));
                if (rd)
                    rate_wait(mod.limit_read_bps, mod.rl_read, len,
                              interrupt_flag);
                else
                    rate_wait(mod.limit_write_bps, mod.rl_write, len,
                              interrupt_flag);
                if (!rd) {
                    if (mod.do_verify)
                        verify_fill(buf, off, len, mod.verify_salt);
                    else if (mod.var_rng && mod.var_pct)
                        mod.var_rng->refill(buf, len, mod.var_pct);
                }
                const uint64_t t0 = now_usec();
                if (mod.flock_mode) {
                    const int lret = op_lock(fd, mod.flock_mode, rd, off,
                                             len, /*unlock=*/false);
                    if (lret != 0) {
                        close(fd);
                        return lret;
                    }
                }
                const ssize_t res = rd
                    ? pread(fd, buf, len, static_cast<off_t>(off))
                    : pwrite(fd, buf, len, static_cast<off_t>(off));
                const int io_errno = res < 0 ? errno : 0;  // before unlock
                out_block_lat[block_idx++] = now_usec() - t0;
                if (mod.flock_mode)
                    op_lock(fd, mod.flock_mode, rd, off, len,
                            /*unlock=*/true);
                if (res < 0) {
                    close(fd);
                    return -io_errno;
                }
                if (static_cast<uint64_t>(res) != len) {
                    close(fd);
                    return -EIO;
                }
                if (!rd && mod.inline_readback) {
                    const ssize_t rres = pread(fd, buf, len,
                                               static_cast<off_t>(off));
                    if (rres < 0 || static_cast<uint64_t>(rres) != len) {
                        const int err = rres < 0 ? errno : EIO;
                        close(fd);
                        return -err;
                    }
                }
                if ((rd || mod.inline_readback) && mod.do_verify) {
                    const int vret = verify_check(
                        buf, off, len, mod.verify_salt, block_idx - 1,
                        mod.verify_info);
                    if (vret != 0) {
                        close(fd);
                        return vret;
                    }
                }
                if (rd && op == FILE_OP_WRITE) {
                    rwmix_blocks++;
                    rwmix_bytes += static_cast<uint64_t>(res);
                }
                bytes_done += static_cast<uint64_t>(res);
                off += len;
            }
            if (close(fd) != 0)
                return -errno;
        }
        out_entry_lat[i] = now_usec() - t_entry;
        ++entries_done;
    }
    *out_bytes = bytes_done;
    *out_entries = entries_done;
    if (mod.out_rwmix_blocks)
        *mod.out_rwmix_blocks = rwmix_blocks;
    if (mod.out_rwmix_bytes)
        *mod.out_rwmix_bytes = rwmix_bytes;
    return 0;
}

}  // namespace

extern "C" {

// engine selector values for ioengine_run_block_loop2
enum { ENGINE_AUTO = 0, ENGINE_SYNC = 1, ENGINE_AIO = 2, ENGINE_URING = 3 };

// file loop with per-block modifiers (verify fill/check, rwmix in-loop
// modulo split, block variance refill) so LOSF phases keep the native
// loop with --verify/--rwmixpct/--blockvarpct active. out_verify_info:
// 4 uint64 slots, {global_block_idx, word_idx, want, got} on -EILSEQ;
// out_rwmix[2]: {blocks, bytes} read by the rwmix split of a write op.
int ioengine_run_file_loop3(const char* paths_blob,
                            const uint32_t* path_offs, uint64_t n_files,
                            int op, int open_flags, uint64_t file_size,
                            uint64_t block_size, void* buf,
                            const uint64_t* range_starts,
                            const uint64_t* range_lens,
                            int ignore_delete_errors,
                            uint64_t* out_entry_lat,
                            uint64_t* out_block_lat,
                            uint64_t* out_bytes, uint64_t* out_entries,
                            uint64_t* out_fail_idx, int* interrupt_flag,
                            uint64_t verify_salt, int do_verify,
                            int block_var_pct, uint64_t block_var_seed,
                            int rwmix_pct, uint64_t rwmix_base,
                            uint64_t* out_verify_info,
                            uint64_t* out_rwmix,
                            uint64_t limit_read_bps,
                            uint64_t limit_write_bps,
                            uint64_t* rl_state,
                            int inline_readback, int flock_mode) {
    *out_fail_idx = 0;
    if (n_files == 0) {
        *out_bytes = 0;
        *out_entries = 0;
        if (out_rwmix)
            out_rwmix[0] = out_rwmix[1] = 0;
        return 0;
    }
    VarRng var_rng(block_var_seed);
    uint64_t info_fallback[4];
    FileLoopMod mod;
    mod.verify_salt = verify_salt;
    mod.do_verify = do_verify;
    mod.var_pct = do_verify ? 0 : block_var_pct;
    mod.var_rng = &var_rng;
    mod.rwmix_pct = (op == FILE_OP_WRITE) ? rwmix_pct : 0;
    mod.rwmix_base = rwmix_base;
    mod.verify_info = out_verify_info ? out_verify_info : info_fallback;
    mod.inline_readback = (op == FILE_OP_WRITE) ? inline_readback : 0;
    mod.flock_mode = flock_mode;
    mod.limit_read_bps = limit_read_bps;
    mod.limit_write_bps = limit_write_bps;
    if (rl_state) {
        mod.rl_read = reinterpret_cast<RateState*>(rl_state);
        mod.rl_write = reinterpret_cast<RateState*>(rl_state + 2);
    }
    if (out_rwmix) {
        mod.out_rwmix_blocks = &out_rwmix[0];
        mod.out_rwmix_bytes = &out_rwmix[1];
    }
    return run_file_loop(paths_blob, path_offs, n_files, op, open_flags,
                         file_size, block_size, static_cast<char*>(buf),
                         range_starts, range_lens, ignore_delete_errors,
                         out_entry_lat, out_block_lat, out_bytes,
                         out_entries, out_fail_idx, interrupt_flag, mod);
}

int ioengine_run_file_loop(const char* paths_blob,
                           const uint32_t* path_offs, uint64_t n_files,
                           int op, int open_flags, uint64_t file_size,
                           uint64_t block_size, void* buf,
                           const uint64_t* range_starts,
                           const uint64_t* range_lens,
                           int ignore_delete_errors,
                           uint64_t* out_entry_lat, uint64_t* out_block_lat,
                           uint64_t* out_bytes, uint64_t* out_entries,
                           uint64_t* out_fail_idx, int* interrupt_flag) {
    return ioengine_run_file_loop3(
        paths_blob, path_offs, n_files, op, open_flags, file_size,
        block_size, buf, range_starts, range_lens, ignore_delete_errors,
        out_entry_lat, out_block_lat, out_bytes, out_entries, out_fail_idx,
        interrupt_flag, 0, 0, 0, 0, 0, 0, nullptr, nullptr, 0, 0, nullptr,
        0, 0);
}

// full-featured variant: adds the in-loop block modifiers (rwmix per-op
// read flags, integrity verify fill/check with exact mismatch reporting,
// block variance refill) so --rwmixpct/--verify/--blockvarpct keep the
// native loop engaged like the reference's hot loop does
// (LocalWorker.cpp:1741,2124,2242). out_verify_info must point to 4
// uint64 slots; on -EILSEQ they hold {block_idx, word_idx, want, got}.
// adds per-thread read/write rate limits to loop3; rl_state points to 4
// caller-owned uint64s {read.window_start, read.bytes, write.window_start,
// write.bytes} so the 1-second windows survive chunked calls
int ioengine_run_block_loop4(const int* fds, const uint32_t* fd_idx,
                             const uint64_t* offsets,
                             const uint64_t* lengths, uint64_t n,
                             int is_write, void* buf, uint64_t buf_size,
                             int iodepth, uint64_t* out_lat_usec,
                             uint64_t* out_bytes, int* interrupt_flag,
                             int engine, const unsigned char* op_is_read,
                             uint64_t verify_salt, int do_verify,
                             int block_var_pct, uint64_t block_var_seed,
                             uint64_t* out_verify_info,
                             uint64_t limit_read_bps,
                             uint64_t limit_write_bps,
                             uint64_t* rl_state,
                             int inline_readback, int flock_mode,
                             int ops_fd, int ops_lock, int worker_rank) {
    if (n == 0) {
        *out_bytes = 0;
        return 0;
    }
    VarRng var_rng(block_var_seed);
    uint64_t info_fallback[4];
    BlockMod mod;
    mod.op_is_read = op_is_read;
    mod.verify_salt = verify_salt;
    mod.do_verify = do_verify;
    mod.var_pct = do_verify ? 0 : block_var_pct;  // verify wins, like the
                                                  // Python _pre_write_fill
    mod.var_rng = &var_rng;
    mod.verify_info = out_verify_info ? out_verify_info : info_fallback;
    mod.limit_read_bps = limit_read_bps;
    mod.limit_write_bps = limit_write_bps;
    if (rl_state) {
        mod.rl_read = reinterpret_cast<RateState*>(rl_state);
        mod.rl_write = reinterpret_cast<RateState*>(rl_state + 2);
    }
    mod.inline_readback = inline_readback;
    mod.flock_mode = flock_mode;
    mod.ops_fd = ops_fd;
    mod.ops_lock = ops_lock;
    mod.worker_rank = worker_rank;
    const bool sync_engine = (engine == ENGINE_SYNC
                              || (engine == ENGINE_AUTO && iodepth <= 1));
    if ((inline_readback || flock_mode) && !sync_engine)
        return -EINVAL;  // per-op lock/readback is a sync-loop feature
    if (engine == ENGINE_URING)
        return run_uring_loop(fds, fd_idx, offsets, lengths, n, is_write,
                              static_cast<const char*>(buf), buf_size,
                              iodepth, out_lat_usec, out_bytes,
                              interrupt_flag, mod);
    if (engine == ENGINE_SYNC || (engine == ENGINE_AUTO && iodepth <= 1))
        return run_sync_loop(fds, fd_idx, offsets, lengths, n, is_write,
                             static_cast<char*>(buf), out_lat_usec,
                             out_bytes, interrupt_flag, mod);
    return run_aio_loop(fds, fd_idx, offsets, lengths, n, is_write,
                        static_cast<const char*>(buf), buf_size, iodepth,
                        out_lat_usec, out_bytes, interrupt_flag, mod);
}

// pool-aware block loop (ABI 11): run_block_loop4 semantics, but when a
// registered-buffer pool handle is given and the engine resolves to
// io_uring, the loop runs on the POOL's persistent ring with its
// once-registered fixed buffers (no per-call ring setup / buffer alloc /
// registration). Any other engine resolution, a busy pool ring (a
// pooled stream is live), or a missing pool falls through to the exact
// loop4 behavior. out_pool_stats: 3 caller-zeroed uint64s
// {fixed_buffer_ops, sqpoll_submits, drain_failed} (may be NULL).
int ioengine_run_block_loop5(void* pool_handle, const int* fds,
                             const uint32_t* fd_idx,
                             const uint64_t* offsets,
                             const uint64_t* lengths, uint64_t n,
                             int is_write, void* buf, uint64_t buf_size,
                             int iodepth, uint64_t* out_lat_usec,
                             uint64_t* out_bytes, int* interrupt_flag,
                             int engine, const unsigned char* op_is_read,
                             uint64_t verify_salt, int do_verify,
                             int block_var_pct, uint64_t block_var_seed,
                             uint64_t* out_verify_info,
                             uint64_t limit_read_bps,
                             uint64_t limit_write_bps,
                             uint64_t* rl_state,
                             int inline_readback, int flock_mode,
                             int ops_fd, int ops_lock, int worker_rank,
                             uint64_t* out_pool_stats) {
    PoolCtx* pool = static_cast<PoolCtx*>(pool_handle);
    if (pool != nullptr && engine == ENGINE_URING && n > 0
            && pool->ring.ring_fd >= 0 && !pool->stream_active
            && !inline_readback && !flock_mode
            && buf_size <= pool->slot_size) {
        VarRng var_rng(block_var_seed);
        uint64_t info_fallback[4];
        BlockMod mod;
        mod.op_is_read = op_is_read;
        mod.verify_salt = verify_salt;
        mod.do_verify = do_verify;
        mod.var_pct = do_verify ? 0 : block_var_pct;
        mod.var_rng = &var_rng;
        mod.verify_info = out_verify_info ? out_verify_info : info_fallback;
        mod.limit_read_bps = limit_read_bps;
        mod.limit_write_bps = limit_write_bps;
        if (rl_state) {
            mod.rl_read = reinterpret_cast<RateState*>(rl_state);
            mod.rl_write = reinterpret_cast<RateState*>(rl_state + 2);
        }
        mod.ops_fd = ops_fd;
        mod.ops_lock = ops_lock;
        mod.worker_rank = worker_rank;
        return run_pool_uring_loop(
            pool, fds, fd_idx, offsets, lengths, n, is_write,
            static_cast<const char*>(buf), buf_size, iodepth,
            out_lat_usec, out_bytes, interrupt_flag, mod, out_pool_stats);
    }
    return ioengine_run_block_loop4(
        fds, fd_idx, offsets, lengths, n, is_write, buf, buf_size,
        iodepth, out_lat_usec, out_bytes, interrupt_flag, engine,
        op_is_read, verify_salt, do_verify, block_var_pct, block_var_seed,
        out_verify_info, limit_read_bps, limit_write_bps, rl_state,
        inline_readback, flock_mode, ops_fd, ops_lock, worker_rank);
}

// multi-fd variant: fd_idx[i] selects fds[] per block (NULL -> fds[0]);
// this is the shared-file striping path (calcFileIdxAndOffsetStriped)
int ioengine_run_block_loop_mf(const int* fds, const uint32_t* fd_idx,
                               const uint64_t* offsets,
                               const uint64_t* lengths, uint64_t n,
                               int is_write, void* buf, uint64_t buf_size,
                               int iodepth, uint64_t* out_lat_usec,
                               uint64_t* out_bytes, int* interrupt_flag,
                               int engine) {
    return ioengine_run_block_loop4(fds, fd_idx, offsets, lengths, n,
                                    is_write, buf, buf_size, iodepth,
                                    out_lat_usec, out_bytes, interrupt_flag,
                                    engine, nullptr, 0, 0, 0, 0, nullptr,
                                    0, 0, nullptr, 0, 0, -1, 0, 0);
}

int ioengine_run_block_loop2(int fd, const uint64_t* offsets,
                             const uint64_t* lengths, uint64_t n,
                             int is_write, void* buf, uint64_t buf_size,
                             int iodepth, uint64_t* out_lat_usec,
                             uint64_t* out_bytes, int* interrupt_flag,
                             int engine) {
    return ioengine_run_block_loop_mf(&fd, nullptr, offsets, lengths, n,
                                      is_write, buf, buf_size, iodepth,
                                      out_lat_usec, out_bytes,
                                      interrupt_flag, engine);
}

int ioengine_run_block_loop(int fd, const uint64_t* offsets,
                            const uint64_t* lengths, uint64_t n,
                            int is_write, void* buf, uint64_t buf_size,
                            int iodepth, uint64_t* out_lat_usec,
                            uint64_t* out_bytes, int* interrupt_flag) {
    return ioengine_run_block_loop2(fd, offsets, lengths, n, is_write, buf,
                                    buf_size, iodepth, out_lat_usec,
                                    out_bytes, interrupt_flag, ENGINE_AUTO);
}

// netbench data plane (reference: BasicSocket C++ + the transfer loops of
// LocalWorker :7789-8064): request/response over established TCP
// connections, fully in native code.

static int send_all_fd(int fd, const char* buf, uint64_t len) {
    uint64_t sent = 0;
    while (sent < len) {
        const ssize_t res = send(fd, buf + sent, len - sent, MSG_NOSIGNAL);
        if (res < 0) {
            if (errno == EINTR)
                continue;
            return -errno;
        }
        sent += static_cast<uint64_t>(res);
    }
    return 0;
}

static int recv_exact_fd(int fd, char* buf, uint64_t len,
                         volatile int* interrupt_flag) {
    uint64_t got = 0;
    int timeouts = 0;  // consecutive SO_RCVTIMEO expiries
    while (got < len) {
        if (interrupt_flag && *interrupt_flag)
            return -EINTR;
        const ssize_t res = recv(fd, buf + got, len - got, 0);
        if (res < 0) {
            if (errno == EINTR)
                continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                // SO_RCVTIMEO expiry: re-check the interrupt flag, give
                // up after ~6 expiries (a wedged peer, like the Python
                // path's bounded recv timeout)
                if (++timeouts > 6)
                    return -ETIMEDOUT;
                continue;
            }
            return -errno;
        }
        if (res == 0)
            return -ECONNRESET;  // peer closed mid-message
        timeouts = 0;
        got += static_cast<uint64_t>(res);
    }
    return 0;
}

// client: n_ops request/response round trips (payload -> block_size bytes,
// response <- resp_size bytes), per-op latency out
int ioengine_net_client_loop(int fd, const void* payload,
                             uint64_t block_size, uint64_t resp_size,
                             uint64_t n_ops, uint64_t* out_lat_usec,
                             uint64_t* out_bytes, int* interrupt_flag) {
    const char* buf = static_cast<const char*>(payload);
    char* resp = resp_size ? static_cast<char*>(malloc(resp_size)) : nullptr;
    if (resp_size && !resp)
        return -ENOMEM;
    uint64_t bytes_done = 0;
    int ret = 0;
    for (uint64_t i = 0; i < n_ops; ++i) {
        if (interrupt_flag && *interrupt_flag)
            break;
        const uint64_t t0 = now_usec();
        ret = send_all_fd(fd, buf, block_size);
        if (ret == 0 && resp_size)
            ret = recv_exact_fd(fd, resp, resp_size, interrupt_flag);
        if (ret != 0)
            break;
        out_lat_usec[i] = now_usec() - t0;
        bytes_done += block_size + resp_size;
    }
    free(resp);
    *out_bytes = bytes_done;
    return ret == -EINTR ? 0 : ret;
}

// server: poll this worker's connection share, answer each full block of
// block_size bytes with resp_size bytes. conn_state[i] carries the bytes
// received toward the current block across calls; UINT64_MAX marks a
// closed connection. Returns after max_responses replies, after
// slice_msecs of polling, or when every connection reached EOF — so the
// Python side can refresh live stats and interrupts between slices.
int ioengine_net_server_loop(const int* fds, uint64_t n_conns,
                             uint64_t* conn_state, uint64_t block_size,
                             uint64_t resp_size, const void* resp_payload,
                             uint64_t max_responses, uint64_t slice_msecs,
                             uint64_t* out_lat_usec, uint64_t* out_bytes,
                             uint64_t* out_responses,
                             uint64_t* out_open_conns,
                             int* interrupt_flag) {
    const uint64_t kClosed = ~0ULL;
    const char* resp = static_cast<const char*>(resp_payload);
    char* scratch = static_cast<char*>(malloc(1 << 20));
    if (!scratch)
        return -ENOMEM;
    pollfd* pfds = new pollfd[n_conns];
    uint64_t responses = 0;
    uint64_t bytes_done = 0;
    int ret = 0;
    const uint64_t t_end = now_usec() + slice_msecs * 1000;

    while (responses < max_responses && now_usec() < t_end) {
        if (interrupt_flag && *interrupt_flag)
            break;
        nfds_t n_open = 0;
        for (uint64_t i = 0; i < n_conns; ++i)
            if (conn_state[i] != kClosed) {
                pfds[n_open].fd = fds[i];
                pfds[n_open].events = POLLIN;
                pfds[n_open].revents = 0;
                ++n_open;
            }
        if (n_open == 0)
            break;
        const int n_ready = poll(pfds, n_open, 100);
        if (n_ready < 0) {
            if (errno == EINTR)
                continue;
            ret = -errno;
            break;
        }
        if (n_ready == 0)
            continue;
        for (nfds_t p = 0; p < n_open && ret == 0; ++p) {
            if (!(pfds[p].revents & (POLLIN | POLLHUP | POLLERR)))
                continue;
            // map back to the conn index (fds may repeat across slices)
            uint64_t idx = 0;
            for (uint64_t i = 0; i < n_conns; ++i)
                if (conn_state[i] != kClosed && fds[i] == pfds[p].fd) {
                    idx = i;
                    break;
                }
            const ssize_t got = recv(pfds[p].fd, scratch, 1 << 20, 0);
            if (got < 0) {
                if (errno == EINTR || errno == EAGAIN
                        || errno == EWOULDBLOCK)
                    continue;
                conn_state[idx] = kClosed;  // treat errors as disconnect
                continue;
            }
            if (got == 0) {
                conn_state[idx] = kClosed;
                continue;
            }
            bytes_done += static_cast<uint64_t>(got);
            conn_state[idx] += static_cast<uint64_t>(got);
            // residual >= block_size carries into the next slice when the
            // response cap is hit, so the cap is checked BEFORE any write
            while (conn_state[idx] != kClosed
                   && conn_state[idx] >= block_size
                   && responses < max_responses) {
                conn_state[idx] -= block_size;
                const uint64_t t0 = now_usec();
                if (resp_size
                        && send_all_fd(pfds[p].fd, resp, resp_size) != 0) {
                    // client died mid-benchmark: only THIS connection is
                    // gone (parity with the recv error handling above)
                    conn_state[idx] = kClosed;
                    break;
                }
                out_lat_usec[responses++] = now_usec() - t0;
                bytes_done += resp_size;
            }
            if (responses >= max_responses)
                break;
        }
    }
    uint64_t open_conns = 0;
    for (uint64_t i = 0; i < n_conns; ++i)
        if (conn_state[i] != kClosed)
            ++open_conns;
    delete[] pfds;
    free(scratch);
    *out_bytes = bytes_done;
    *out_responses = responses;
    *out_open_conns = open_conns;
    return ret;
}

// mmap-backed block loop: pure memcpy between the mapping and the io
// buffer with the usual latency/interrupt semantics (reference: the mmap
// wrappers of LocalWorker; --mmap). The "2" variant carries the same
// per-block modifiers as the block loops (verify fill/check, rwmix
// per-op flags, variance refill).
int ioengine_run_mmap_loop3(void* map_base, const uint64_t* offsets,
                            const uint64_t* lengths, uint64_t n,
                            int is_write, void* buf,
                            uint64_t* out_lat_usec, uint64_t* out_bytes,
                            int* interrupt_flag,
                            const unsigned char* op_is_read,
                            uint64_t verify_salt, int do_verify,
                            int block_var_pct, uint64_t block_var_seed,
                            uint64_t* out_verify_info,
                            uint64_t limit_read_bps,
                            uint64_t limit_write_bps,
                            uint64_t* rl_state) {
    char* base = static_cast<char*>(map_base);
    char* io = static_cast<char*>(buf);
    VarRng var_rng(block_var_seed);
    uint64_t info_fallback[4];
    BlockMod mod;
    mod.op_is_read = op_is_read;
    mod.verify_salt = verify_salt;
    mod.do_verify = do_verify;
    mod.var_pct = do_verify ? 0 : block_var_pct;
    mod.var_rng = &var_rng;
    mod.verify_info = out_verify_info ? out_verify_info : info_fallback;
    mod.limit_read_bps = limit_read_bps;
    mod.limit_write_bps = limit_write_bps;
    if (rl_state) {
        mod.rl_read = reinterpret_cast<RateState*>(rl_state);
        mod.rl_write = reinterpret_cast<RateState*>(rl_state + 2);
    }
    uint64_t bytes_done = 0;
    for (uint64_t i = 0; i < n; ++i) {
        if ((i % kInterruptCheckInterval) == 0 && interrupt_flag
                && *interrupt_flag)
            break;
        const uint64_t len = lengths[i];
        const uint64_t off = offsets[i];
        const bool rd = mod.op_reads(i, is_write);
        mod.rate_limit(rd, len, interrupt_flag);
        if (!rd)
            mod.pre_write(io, off, len);
        const uint64_t t0 = now_usec();
        if (rd)
            memcpy(io, base + off, len);
        else
            memcpy(base + off, io, len);
        out_lat_usec[i] = now_usec() - t0;
        if (rd) {
            const int vret = mod.post_read(io, off, len, i);
            if (vret != 0)
                return vret;
        }
        bytes_done += len;
    }
    *out_bytes = bytes_done;
    return 0;
}

int ioengine_run_mmap_loop(void* map_base, const uint64_t* offsets,
                           const uint64_t* lengths, uint64_t n,
                           int is_write, void* buf,
                           uint64_t* out_lat_usec, uint64_t* out_bytes,
                           int* interrupt_flag) {
    return ioengine_run_mmap_loop3(map_base, offsets, lengths, n, is_write,
                                   buf, out_lat_usec, out_bytes,
                                   interrupt_flag, nullptr, 0, 0, 0, 0,
                                   nullptr, 0, 0, nullptr);
}

// ---------------------------------------------------------------------------
// streaming producer mode entry points (see StreamCtx above for the
// contract). All return 0/handle on success, -errno on failure.

int ioengine_uring_supported();  // defined below; used by stream_backend

// open a stream over the caller's staging slots. slot_addrs[i] is the
// base address of slot i (page-aligned worker I/O buffers); every op on
// slot i reads into / writes from that buffer. Registered buffers/files
// are pure fast-path optimizations — registration failure (e.g.
// RLIMIT_MEMLOCK) silently falls back to the unregistered opcodes.
// Returns NULL with *out_err = -errno when the ring cannot be set up
// (kernel without io_uring / EXT_ARG -> -ENOSYS: the caller's cue to
// fall back to the Python loop).
void* ioengine_stream_open(const int* fds, uint32_t n_fds,
                           const uint64_t* slot_addrs, uint64_t n_slots,
                           uint64_t slot_size, int* out_err) {
    if (!n_slots || !n_fds || !slot_addrs || !fds || !slot_size) {
        if (out_err)
            *out_err = -EINVAL;
        return nullptr;
    }
    StreamCtx* c = new StreamCtx;
    c->use_uring = c->rings().init(static_cast<unsigned>(n_slots)) == 0;
    if (!c->use_uring) {
        // kernel without io_uring/EXT_ARG: same ring semantics on
        // kernel AIO (io_submit/io_getevents)
        if (sys_io_setup(static_cast<unsigned>(n_slots), &c->aio_ctx) < 0) {
            if (out_err)
                *out_err = -errno;
            c->aio_ctx = 0;
            delete c;
            return nullptr;
        }
        c->aio_cbs = new iocb[n_slots];
    }
    c->n_slots = n_slots;
    c->slot_size = slot_size;
    c->slots = new StreamSlotState[n_slots];
    c->slot_addrs = new uint64_t[n_slots];
    memcpy(c->slot_addrs, slot_addrs, n_slots * sizeof(uint64_t));
    c->n_fds = n_fds;
    c->fds = new int[n_fds];
    memcpy(c->fds, fds, n_fds * sizeof(int));
    if (c->use_uring) {
        iovec* iov = new iovec[n_slots];
        for (uint64_t i = 0; i < n_slots; ++i) {
            iov[i].iov_base = reinterpret_cast<void*>(slot_addrs[i]);
            iov[i].iov_len = slot_size;
        }
        c->fixed_buffers = sys_io_uring_register(
            c->rings().ring_fd, IORING_REGISTER_BUFFERS, iov,
            static_cast<unsigned>(n_slots)) == 0;
        delete[] iov;
        c->fixed_files = sys_io_uring_register(
            c->rings().ring_fd, IORING_REGISTER_FILES, c->fds, n_fds) == 0;
    }
    if (out_err)
        *out_err = 0;
    return c;
}

// open a stream over the POOL's persistent ring (ABI 11): the pool slab
// is already registered as fixed buffers, so this open pays no ring
// setup and no get_user_pages pin — just slot-state allocation. The
// stream ops run on the pool's slots (slot i == pool slot i); n_slots/
// slot_size come from the pool. SQPOLL rides along when the pool was
// opened with it. Fails with -EBUSY when another stream already owns
// the ring, -ENOSYS when the pool has no ring (caller falls back to
// ioengine_stream_open).
void* ioengine_stream_open_pooled(void* pool_handle, const int* fds,
                                  uint32_t n_fds, int* out_err) {
    PoolCtx* pool = static_cast<PoolCtx*>(pool_handle);
    if (!pool || !n_fds || !fds) {
        if (out_err)
            *out_err = -EINVAL;
        return nullptr;
    }
    if (pool->ring.ring_fd < 0) {
        if (out_err)
            *out_err = -ENOSYS;
        return nullptr;
    }
    if (pool->stream_active) {
        if (out_err)
            *out_err = -EBUSY;
        return nullptr;
    }
    StreamCtx* c = new StreamCtx;
    c->pool = pool;
    c->use_uring = true;
    c->n_slots = pool->n_slots;
    c->slot_size = pool->slot_size;
    c->slots = new StreamSlotState[pool->n_slots];
    c->slot_addrs = new uint64_t[pool->n_slots];
    memcpy(c->slot_addrs, pool->slot_addrs,
           pool->n_slots * sizeof(uint64_t));
    c->n_fds = n_fds;
    c->fds = new int[n_fds];
    memcpy(c->fds, fds, n_fds * sizeof(int));
    c->fixed_buffers = pool->fixed_buffers;
    c->fixed_files = false;  // fds change per phase; plain fds in SQEs
    pool->stream_active = true;
    if (out_err)
        *out_err = 0;
    return c;
}

// the backend a LIVE stream actually uses (the open may have fallen
// back to AIO even where the 1-entry uring probe succeeds, e.g. ENOMEM
// on the ring mmaps at a large slot count) — callers enforcing an
// explicit --ioengine pin must check THIS, not the prediction below
int ioengine_stream_backend_of(void* handle) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    if (!c)
        return 0;
    return c->use_uring ? ENGINE_URING : ENGINE_AIO;
}

// which backend serves a stream on this kernel: 3 = io_uring, 2 = kernel
// AIO, 0 = neither (stream_open would fail; Python loop territory).
// Values match the ENGINE_* selector codes so logs/tests share one vocab.
int ioengine_stream_backend() {
    if (ioengine_uring_supported())
        return ENGINE_URING;
    aio_context_t probe = 0;
    if (sys_io_setup(1, &probe) == 0) {
        sys_io_destroy(probe);
        return ENGINE_AIO;
    }
    return 0;
}

// queue + submit one op on a free slot; the read lands in (or the write
// is served from) the first `length` bytes of the slot's buffer
int ioengine_stream_submit(void* handle, uint32_t slot, uint32_t fd_idx,
                           uint64_t offset, uint64_t length, int is_write) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    if (!c || slot >= c->n_slots || fd_idx >= c->n_fds
            || length > c->slot_size || length == 0)
        return -EINVAL;
    StreamSlotState& s = c->slots[slot];
    if (s.pending)
        return -EBUSY;  // slot-reuse discipline: one in-flight op per slot
    // deterministic fault schedule, decided at submit time so it is
    // independent of completion order (reap applies EIO/short to the
    // real result; a hang op never reaches the kernel at all)
    const uint64_t op_idx = c->submit_counter++;
    s.fault_kind = (c->fault_every_n
                    && (op_idx + c->fault_seed) % c->fault_every_n == 0)
        ? c->fault_kind : STREAM_FAULT_NONE;
    ++s.gen;  // see stream_user_data: cancel-vs-re-arm race immunity
    s.cancel_sent = 0;
    s.deadline_hit = 0;
    s.synth_pending = 0;
    if (s.fault_kind == STREAM_FAULT_HANG) {
        // injected hang: the slot is in flight but no kernel op exists —
        // it only completes via the --iotimeout deadline or an explicit
        // cancel (both synthesize the completion)
        s.submit_usec = now_usec();
        s.expected_len = length;
        s.kernel_owned = 0;
        s.pending = 1;
        ++c->in_flight;
        return 0;
    }
    if (!c->use_uring) {  // kernel-AIO fallback backend
        iocb& cb = c->aio_cbs[slot];
        memset(&cb, 0, sizeof(cb));
        cb.aio_fildes = static_cast<uint32_t>(c->fds[fd_idx]);
        cb.aio_lio_opcode = is_write ? IOCB_CMD_PWRITE : IOCB_CMD_PREAD;
        cb.aio_buf = c->slot_addrs[slot];
        cb.aio_nbytes = length;
        cb.aio_offset = static_cast<int64_t>(offset);
        cb.aio_data = stream_user_data(slot, s.gen);
        s.submit_usec = now_usec();
        s.expected_len = length;
        iocb* cbp = &cb;
        if (sys_io_submit(c->aio_ctx, 1, &cbp) != 1)
            return -errno;
        s.kernel_owned = 1;
        s.pending = 1;
        ++c->in_flight;
        return 0;
    }
    UringRings& r = c->rings();
    if (r.sqpoll && r.sq_full())
        return -EAGAIN;  // SQPOLL thread lagging; caller reaps and retries
    const unsigned tail = *r.sq_tail;
    const unsigned idx = tail & *r.sq_mask;
    io_uring_sqe* sqe = &r.sqes[idx];
    memset(sqe, 0, sizeof(*sqe));
    if (c->fixed_buffers) {
        sqe->opcode = is_write ? IORING_OP_WRITE_FIXED
                               : IORING_OP_READ_FIXED;
        sqe->buf_index = static_cast<uint16_t>(slot);
    } else {
        sqe->opcode = is_write ? IORING_OP_WRITE : IORING_OP_READ;
    }
    if (c->fixed_files) {
        sqe->fd = static_cast<int32_t>(fd_idx);
        sqe->flags |= IOSQE_FIXED_FILE;
    } else {
        sqe->fd = c->fds[fd_idx];
    }
    sqe->addr = c->slot_addrs[slot];
    sqe->len = static_cast<uint32_t>(length);
    sqe->off = offset;
    sqe->user_data = stream_user_data(slot, s.gen);
    r.sq_array[idx] = idx;
    s.submit_usec = now_usec();
    s.expected_len = length;
    __atomic_store_n(r.sq_tail, tail + 1, __ATOMIC_RELEASE);
    // SQPOLL (pool ring): the polling thread consumes the published
    // tail asynchronously — flush_submissions only pays a syscall when
    // the idle thread went to sleep. Without SQPOLL it is the usual
    // 1-op synchronous enter.
    const int res = r.flush_submissions(1);
    if (res != 1) {
        // the kernel did not consume the SQE (no SQPOLL: it only reads
        // during enter) — rewind the published tail or the orphaned
        // entry would be submitted in place of the NEXT op, desyncing
        // every later slot<->completion mapping
        __atomic_store_n(r.sq_tail, tail, __ATOMIC_RELEASE);
        return res < 0 ? res : -EAGAIN;
    }
    s.kernel_owned = 1;
    s.pending = 1;
    ++c->in_flight;
    return 0;
}

// ---------------------------------------------------------------------------
// per-op deadlines + cancellation (--iotimeout; engine ABI 10)

// arm/disarm the per-op deadline: ops older than timeout_usec at reap
// time are cancelled and surfaced as -ETIMEDOUT with the slot re-armed
int ioengine_stream_set_timeout(void* handle, uint64_t timeout_usec) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    if (!c)
        return -EINVAL;
    c->op_timeout_usec = timeout_usec;
    return 0;
}

// arm deterministic fault injection (TEST ONLY; see STREAM_FAULT_*).
// every_n == 0 disarms. The schedule keys on the submit counter, so the
// same (seed, every_n) faults the same ops run after run.
int ioengine_stream_set_fault(void* handle, uint64_t seed,
                              uint64_t every_n, int kind) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    if (!c || kind < STREAM_FAULT_NONE || kind > STREAM_FAULT_HANG)
        return -EINVAL;
    c->fault_seed = seed;
    c->fault_every_n = every_n;
    c->fault_kind = every_n ? kind : STREAM_FAULT_NONE;
    return 0;
}

// age of the oldest in-flight op in usec (op age tracking for
// diagnostics/tests), 0 when nothing is in flight
int64_t ioengine_stream_oldest_age_usec(void* handle) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    if (!c)
        return -EINVAL;
    uint64_t oldest = 0;
    const uint64_t now = now_usec();
    for (uint64_t i = 0; i < c->n_slots; ++i) {
        const StreamSlotState& s = c->slots[i];
        if (s.pending && now - s.submit_usec > oldest)
            oldest = now - s.submit_usec;
    }
    return static_cast<int64_t>(oldest);
}

// issue cancellation of one slot's kernel op (uring ASYNC_CANCEL keyed
// by user_data; AIO io_cancel best-effort). The completion surfaces via
// reap: -ECANCELED for an explicit cancel, -ETIMEDOUT when the cancel
// came from the deadline scan. Returns 0 when the cancel was issued (or
// synthesized), -ENOENT when the slot has no in-flight op.
static int stream_cancel_slot(StreamCtx* c, uint32_t slot,
                              int deadline_initiated) {
    StreamSlotState& s = c->slots[slot];
    if (!s.pending)
        return -ENOENT;
    if (deadline_initiated)
        s.deadline_hit = 1;
    if (!s.kernel_owned) {
        // injected hang: no kernel op exists — complete synthetically
        s.synth_pending = 1;
        s.synth_res = deadline_initiated ? -ETIMEDOUT : -ECANCELED;
        return 0;
    }
    if (s.cancel_sent)
        return 0;
    s.cancel_sent = 1;
    if (!c->use_uring) {
        io_event result;
        memset(&result, 0, sizeof(result));
        if (sys_io_cancel(c->aio_ctx, &c->aio_cbs[slot], &result) == 0) {
            // kernel dropped the op: no event will be delivered for it
            s.synth_pending = 1;
            s.synth_res = deadline_initiated ? -ETIMEDOUT : -ECANCELED;
        }
        // EINVAL/EAGAIN: disk AIO is rarely cancellable — the op will
        // complete normally; deadline_hit rewrites a late -ECANCELED/
        // -EINTR result, a real result passes through (the op made it)
        return 0;
    }
    UringRings& r = c->rings();
    if (r.sqpoll && r.sq_full()) {
        s.cancel_sent = 0;  // no SQ space; the deadline scan may retry
        return -EAGAIN;
    }
    const unsigned tail = *r.sq_tail;
    const unsigned idx = tail & *r.sq_mask;
    io_uring_sqe* sqe = &r.sqes[idx];
    memset(sqe, 0, sizeof(*sqe));
    sqe->opcode = kOpAsyncCancel;
    sqe->fd = -1;
    // cancel target: THIS generation's user_data — a stale cancel that
    // outlives the op can never match the slot's next (re-armed) op
    sqe->addr = stream_user_data(slot, s.gen);
    sqe->user_data = kStreamCancelTag | slot;
    r.sq_array[idx] = idx;
    __atomic_store_n(r.sq_tail, tail + 1, __ATOMIC_RELEASE);
    const int res = r.flush_submissions(1);
    if (res != 1) {
        __atomic_store_n(r.sq_tail, tail, __ATOMIC_RELEASE);
        s.cancel_sent = 0;  // not issued; the deadline scan may retry
        return res < 0 ? res : -EAGAIN;
    }
    ++c->cancel_inflight;
    return 0;
}

int ioengine_stream_cancel(void* handle, uint32_t slot) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    if (!c || slot >= c->n_slots)
        return -EINVAL;
    return stream_cancel_slot(c, slot, /*deadline_initiated=*/0);
}

// harvest queued synthetic completions (injected-hang timeouts,
// successful cancels of ops the kernel never saw/dropped) into the
// reap out-arrays; re-arms each slot
static void stream_collect_synth(StreamCtx* c, uint32_t* out_slots,
                                 uint64_t* out_lat_usec, int64_t* out_res,
                                 int max_events, int* got) {
    const uint64_t now = now_usec();
    for (uint64_t i = 0; i < c->n_slots && *got < max_events; ++i) {
        StreamSlotState& s = c->slots[i];
        if (!s.pending || !s.synth_pending)
            continue;
        s.pending = 0;
        s.synth_pending = 0;
        s.kernel_owned = 0;
        --c->in_flight;
        out_slots[*got] = static_cast<uint32_t>(i);
        out_lat_usec[*got] = now - s.submit_usec;
        out_res[*got] = s.synth_res;
        ++(*got);
    }
}

// deadline scan: cancel every in-flight op older than --iotimeout (a
// hung op must surface as -ETIMEDOUT with its slot re-armed instead of
// wedging the reap loop forever)
static void stream_apply_deadlines(StreamCtx* c) {
    if (!c->op_timeout_usec)
        return;
    const uint64_t now = now_usec();
    for (uint64_t i = 0; i < c->n_slots; ++i) {
        StreamSlotState& s = c->slots[i];
        if (s.pending && !s.synth_pending
                && now - s.submit_usec >= c->op_timeout_usec)
            stream_cancel_slot(c, static_cast<uint32_t>(i),
                               /*deadline_initiated=*/1);
    }
}

// decode a data-op completion: the slot index, validated against the
// slot's CURRENT generation (a completion for a superseded/synthetically
// retired op is dropped — its in_flight decrement already happened)
static StreamSlotState* stream_match(StreamCtx* c, uint64_t ud,
                                     uint32_t* out_slot) {
    const uint32_t slot = static_cast<uint32_t>(ud & 0xFFFFFFFFu);
    if (slot >= c->n_slots)
        return nullptr;
    StreamSlotState& s = c->slots[slot];
    if (!s.pending
            || static_cast<uint32_t>((ud >> 32) & 0x7FFFFFFFu)
               != (s.gen & 0x7FFFFFFFu))
        return nullptr;
    *out_slot = slot;
    return &s;
}

// per-op result shaping at harvest: injected EIO/short-read faults, and
// the deadline rewrite of a cancelled op's -ECANCELED/-EINTR into
// -ETIMEDOUT (a real result that beat the cancel passes through — the
// data arrived, the deadline check is moot for that op)
static int64_t stream_shape_result(StreamSlotState& s, int64_t res) {
    if (s.fault_kind == STREAM_FAULT_EIO && res >= 0)
        res = -EIO;
    else if (s.fault_kind == STREAM_FAULT_SHORT && res > 1)
        res = res / 2;
    if (s.deadline_hit && (res == -ECANCELED || res == -EINTR))
        res = -ETIMEDOUT;
    return res;
}

// harvest up to max_events completions, blocking (bounded, interruptible)
// until at least min_complete arrived or timeout_msecs elapsed. Returns
// the number reaped (may be < min_complete on timeout/interrupt/empty
// ring), or -errno on an unrecoverable wait error. Per event: the slot
// index, the submit->harvest latency in usec, and the raw cqe result
// (>= 0 bytes moved — the caller checks it against the expected length —
// or -errno for that op).
int ioengine_stream_reap(void* handle, int min_complete, int timeout_msecs,
                         uint32_t* out_slots, uint64_t* out_lat_usec,
                         int64_t* out_res, int max_events,
                         int* interrupt_flag) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    if (!c || max_events <= 0 || !out_slots || !out_lat_usec || !out_res)
        return -EINVAL;
    if (min_complete > max_events)
        min_complete = max_events;
    int got = 0;
    const uint64_t deadline = now_usec()
        + static_cast<uint64_t>(timeout_msecs < 0 ? 0 : timeout_msecs)
          * 1000ull;
    if (!c->use_uring) {  // kernel-AIO fallback backend
        io_event events[16];
        for (;;) {
            // --iotimeout scan + queued synthetic completions (injected
            // hangs, successfully cancelled ops) before touching the
            // kernel: a hung op must re-arm its slot, not wedge the wait
            stream_apply_deadlines(c);
            stream_collect_synth(c, out_slots, out_lat_usec, out_res,
                                 max_events, &got);
            if (got >= max_events)
                return got;
            const long want = max_events - got > 16 ? 16 : max_events - got;
            // harvest whatever already completed without blocking
            timespec zero = {0, 0};
            int n = sys_io_getevents(c->aio_ctx, 0, want, events, &zero);
            if (n < 0) {
                if (errno == EINTR)
                    continue;
                return got ? got : -errno;
            }
            const uint64_t t_now = now_usec();
            for (int e = 0; e < n; ++e) {
                uint32_t slot;
                StreamSlotState* s = stream_match(c, events[e].data,
                                                  &slot);
                if (s) {
                    s->pending = 0;
                    s->kernel_owned = 0;
                    --c->in_flight;
                    out_slots[got] = slot;
                    out_lat_usec[got] = t_now - s->submit_usec;
                    out_res[got] = stream_shape_result(*s, events[e].res);
                    ++got;
                }
            }
            if (got >= min_complete || c->in_flight == 0)
                return got;
            if (interrupt_flag && *interrupt_flag)
                return got;
            const uint64_t now2 = now_usec();
            if (now2 >= deadline)
                return got;
            uint64_t wait_us = deadline - now2;
            if (wait_us > 100000)  // interruptible 100ms slices; also the
                wait_us = 100000;  // --iotimeout re-scan cadence
            timespec ts = {static_cast<time_t>(wait_us / 1000000ull),
                           static_cast<long>((wait_us % 1000000ull)
                                             * 1000ull)};
            // recompute the bound: the harvest above advanced `got`, and
            // reusing the stale `want` could overrun the out arrays
            const long want2 = max_events - got > 16 ? 16
                                                     : max_events - got;
            // with only non-kernel ops in flight (injected hangs) there
            // is no event to wait for: sleep the slice and re-scan
            int kernel_inflight = 0;
            for (uint64_t i = 0; i < c->n_slots; ++i)
                if (c->slots[i].pending && c->slots[i].kernel_owned)
                    ++kernel_inflight;
            if (!kernel_inflight) {
                usleep(static_cast<useconds_t>(wait_us));
                continue;
            }
            n = sys_io_getevents(c->aio_ctx, 1, want2, events, &ts);
            if (n < 0 && errno != EINTR)
                return got ? got : -errno;
            if (n > 0) {
                const uint64_t t_done = now_usec();
                for (int e = 0; e < n; ++e) {
                    uint32_t slot;
                    StreamSlotState* s = stream_match(c, events[e].data,
                                                      &slot);
                    if (s) {
                        s->pending = 0;
                        s->kernel_owned = 0;
                        --c->in_flight;
                        out_slots[got] = slot;
                        out_lat_usec[got] = t_done - s->submit_usec;
                        out_res[got] = stream_shape_result(*s,
                                                           events[e].res);
                        ++got;
                    }
                }
                if (got >= min_complete || c->in_flight == 0)
                    return got;
            }
        }
    }
    for (;;) {
        stream_apply_deadlines(c);
        stream_collect_synth(c, out_slots, out_lat_usec, out_res,
                             max_events, &got);
        if (got >= max_events)
            return got;
        unsigned head = *c->rings().cq_head;
        const unsigned tail =
            __atomic_load_n(c->rings().cq_tail, __ATOMIC_ACQUIRE);
        const uint64_t t_now = now_usec();
        while (head != tail && got < max_events) {
            const io_uring_cqe& cqe =
                c->rings().cqes[head & *c->rings().cq_mask];
            const uint64_t ud = cqe.user_data;
            ++head;
            if (ud & kStreamCancelTag) {
                // the ASYNC_CANCEL op's own completion — bookkeeping
                // only, never a data-op event
                --c->cancel_inflight;
                continue;
            }
            uint32_t slot;
            StreamSlotState* s = stream_match(c, ud, &slot);
            if (s) {
                s->pending = 0;
                s->kernel_owned = 0;
                --c->in_flight;
                out_slots[got] = slot;
                out_lat_usec[got] = t_now - s->submit_usec;
                out_res[got] = stream_shape_result(*s, cqe.res);
                ++got;
            }
        }
        __atomic_store_n(c->rings().cq_head, head, __ATOMIC_RELEASE);
        if (got >= min_complete || c->in_flight == 0)
            return got;
        if (interrupt_flag && *interrupt_flag)
            return got;
        const uint64_t now2 = now_usec();
        if (now2 >= deadline)
            return got;
        // bounded wait in <=100ms slices so interrupts stay responsive
        // (and the --iotimeout deadline scan re-runs at that cadence)
        uint64_t wait_us = deadline - now2;
        if (wait_us > 100000)
            wait_us = 100000;
        // with only non-kernel ops in flight (injected hangs) there is
        // no CQE to wait for: sleep the slice and re-scan
        int kernel_inflight = 0;
        for (uint64_t i = 0; i < c->n_slots; ++i)
            if (c->slots[i].pending && c->slots[i].kernel_owned)
                ++kernel_inflight;
        if (!kernel_inflight && !c->cancel_inflight) {
            usleep(static_cast<useconds_t>(wait_us));
            continue;
        }
        timespec ts = {static_cast<time_t>(wait_us / 1000000ull),
                       static_cast<long>((wait_us % 1000000ull) * 1000ull)};
        UringGetEventsArg arg;
        memset(&arg, 0, sizeof(arg));
        arg.ts = reinterpret_cast<uint64_t>(&ts);
        if (sys_io_uring_enter(
                c->rings().ring_fd, 0, 1,
                IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG, &arg,
                sizeof(arg)) < 0
                && errno != ETIME && errno != EINTR)
            return got ? got : -errno;
    }
}

// ops the kernel currently owns (submitted, not yet reaped)
int ioengine_stream_inflight(void* handle) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    return c ? c->in_flight : -EINVAL;
}

// drain outstanding kernel DMA into the slot buffers, then tear the ring
// down. The drain must complete before the caller may unmap the slots
// (same use-after-free argument as run_uring_loop's drain); an
// unrecoverable enter error aborts it with -EIO, and the caller MUST
// then keep the slot buffers mapped for the life of the process (the
// Python side leaks the worker's mmaps on a nonzero return) — a late
// completion still DMAs into them.
int ioengine_stream_close(void* handle) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    if (!c)
        return -EINVAL;
    int ret = 0;
    // retire in-flight ops the kernel never saw (injected hangs, ops a
    // successful io_cancel dropped): no completion will ever arrive for
    // them, so the drain loops below must not wait on their count
    for (uint64_t i = 0; i < c->n_slots; ++i) {
        StreamSlotState& s = c->slots[i];
        if (s.pending && !s.kernel_owned) {
            s.pending = 0;
            --c->in_flight;
        } else if (s.pending && s.synth_pending) {
            // synthetic completion queued for a kernel-dropped op
            s.pending = 0;
            --c->in_flight;
        }
    }
    if (!c->use_uring) {
        // AIO drain; io_destroy in the dtor then blocks until any
        // remainder's kernel DMA finished (same ordering argument as
        // run_aio_loop's teardown). BOUNDED: a truly hung, un-cancellable
        // op (hard-mounted NFS) must not wedge teardown forever — after
        // 30 zero-progress seconds the context is LEAKED (io_destroy on
        // it would block just the same) and -EIO tells the caller to
        // keep the slot buffers mapped for the life of the process.
        int stalled_secs = 0;
        while (c->in_flight > 0 && stalled_secs < 30) {
            io_event events[16];
            timespec ts = {1, 0};
            const int n = sys_io_getevents(c->aio_ctx, 1, 16, events, &ts);
            if (n < 0 && errno != EINTR)
                break;
            if (n > 0) {
                c->in_flight -= n;
                stalled_secs = 0;
            } else {
                ++stalled_secs;
            }
        }
        if (c->in_flight > 0) {
            ret = -EIO;
            c->aio_ctx = 0;  // leak: destroying would block on the hang
        }
        delete c;
        return ret;
    }
    int stalled_secs = 0;
    while (c->in_flight > 0) {
        unsigned head = *c->rings().cq_head;
        const unsigned tail =
            __atomic_load_n(c->rings().cq_tail, __ATOMIC_ACQUIRE);
        if (head == tail) {
            // bounded like the AIO drain: a hung op must not wedge
            // teardown — give up after 30 zero-progress seconds with
            // -EIO (the caller then leaks the slot buffers)
            if (++stalled_secs > 30) {
                ret = -EIO;
                break;
            }
            timespec ts = {1, 0};
            UringGetEventsArg arg;
            memset(&arg, 0, sizeof(arg));
            arg.ts = reinterpret_cast<uint64_t>(&ts);
            if (sys_io_uring_enter(
                    c->rings().ring_fd, 0, 1,
                    IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG,
                    &arg, sizeof(arg)) < 0
                    && errno != ETIME && errno != EINTR) {
                ret = -EIO;
                break;
            }
            continue;
        }
        stalled_secs = 0;
        while (head != tail) {
            // a cancel op's own CQE is bookkeeping, not a data-op
            // completion — counting it would under-drain the real ops
            const io_uring_cqe& cqe =
                c->rings().cqes[head & *c->rings().cq_mask];
            ++head;
            if (cqe.user_data & kStreamCancelTag)
                --c->cancel_inflight;
            else
                --c->in_flight;
        }
        __atomic_store_n(c->rings().cq_head, head, __ATOMIC_RELEASE);
    }
    if (c->pool != nullptr) {
        // borrowed pool ring: release it ONLY after a clean drain — a
        // failed drain leaves kernel-owned ops targeting pool slots, so
        // the ring stays marked busy and the caller must stop using the
        // pool (and keep the slab mapped for the life of the process)
        if (ret == 0)
            c->pool->stream_active = false;
        delete c;  // the owned (never-initialized) ring dtor is a no-op
        return ret;
    }
    delete c;  // UringRings dtor unmaps the rings and closes the fd
    return ret;
}

// ---------------------------------------------------------------------------
// registered-buffer staging pool entry points (ABI 11; see PoolCtx)

// open a persistent pool ring over the caller's staging slab and
// register the slots as fixed buffers ONCE. want_sqpoll != 0 asks for a
// kernel submission-queue polling thread (idle timeout in ms) — when
// the kernel refuses SQPOLL (EPERM pre-5.11 unprivileged, compiled
// out), the open RETRIES without it and reports the downgrade via
// ioengine_pool_features, so the caller can log the loud fallback.
// Returns NULL with *out_err when no ring can be set up at all (the
// caller then keeps today's per-call paths).
void* ioengine_pool_open(const uint64_t* slot_addrs, uint64_t n_slots,
                         uint64_t slot_size, int want_sqpoll,
                         uint32_t sqpoll_idle_ms, int* out_err) {
    if (!slot_addrs || !n_slots || !slot_size) {
        if (out_err)
            *out_err = -EINVAL;
        return nullptr;
    }
    PoolCtx* pool = new PoolCtx;
    // 2x slots of SQ entries: data ops are bounded by the slot count,
    // but ASYNC_CANCEL SQEs of a pooled stream ride the same ring and
    // must never find it full
    const unsigned entries = static_cast<unsigned>(n_slots * 2);
    int ret = -ENOSYS;
    if (want_sqpoll)
        ret = pool->ring.init(entries, IORING_SETUP_SQPOLL,
                              sqpoll_idle_ms ? sqpoll_idle_ms : 2000);
    if (ret != 0) {  // no-SQPOLL retry (or the plain first attempt)
        // a partially-successful SQPOLL attempt (e.g. ring up but no
        // EXT_ARG) left an fd + mappings behind: drop them first
        pool->ring.reset();
        ret = pool->ring.init(entries);
    }
    if (ret != 0) {
        if (out_err)
            *out_err = ret;
        delete pool;
        return nullptr;
    }
    pool->n_slots = n_slots;
    pool->slot_size = slot_size;
    pool->slot_addrs = new uint64_t[n_slots];
    memcpy(pool->slot_addrs, slot_addrs, n_slots * sizeof(uint64_t));
    iovec* iov = new iovec[n_slots];
    for (uint64_t i = 0; i < n_slots; ++i) {
        iov[i].iov_base = reinterpret_cast<void*>(slot_addrs[i]);
        iov[i].iov_len = slot_size;
    }
    // the ONE registration of the pool's lifetime (pages stay pinned:
    // no per-ring get_user_pages ever again); EPERM/ENOMEM (e.g.
    // RLIMIT_MEMLOCK) degrades to unregistered opcodes, reported via
    // features so the fallback is loud on the Python side
    pool->fixed_buffers = sys_io_uring_register(
        pool->ring.ring_fd, IORING_REGISTER_BUFFERS, iov,
        static_cast<unsigned>(n_slots)) == 0;
    delete[] iov;
    if (out_err)
        *out_err = 0;
    return pool;
}

// POOL_FEAT_* bitmask of a live pool (0 for NULL)
int ioengine_pool_features(void* handle) {
    PoolCtx* pool = static_cast<PoolCtx*>(handle);
    if (!pool)
        return 0;
    int feats = 0;
    if (pool->ring.ring_fd >= 0)
        feats |= POOL_FEAT_URING;
    if (pool->fixed_buffers)
        feats |= POOL_FEAT_FIXED_BUFFERS;
    if (pool->ring.sqpoll)
        feats |= POOL_FEAT_SQPOLL;
    return feats;
}

// tear the pool ring down (unregisters the fixed buffers implicitly).
// -EBUSY when a pooled stream still owns the ring (close the stream
// first — its drain guarantees no kernel DMA targets the slab).
int ioengine_pool_close(void* handle) {
    PoolCtx* pool = static_cast<PoolCtx*>(handle);
    if (!pool)
        return -EINVAL;
    if (pool->stream_active)
        return -EBUSY;
    delete pool;  // UringRings dtor unmaps and closes the ring fd
    return 0;
}

// 1 if this kernel grants an SQPOLL ring to this process (unprivileged
// needs 5.11+; may also be refused by RLIMIT/seccomp policy) — the
// capability probe behind --iosqpoll's loud fallback
int ioengine_sqpoll_supported() {
    io_uring_params p;
    memset(&p, 0, sizeof(p));
    p.flags = IORING_SETUP_SQPOLL;
    p.sq_thread_idle = 100;
    int fd = sys_io_uring_setup(1, &p);
    if (fd < 0)
        return 0;
    close(fd);
    return (p.features & IORING_FEAT_EXT_ARG) ? 1 : 0;
}

// 1 when a live stream's ops run READ/WRITE_FIXED against registered
// buffers (per-open registration or the borrowed pool's) — the
// verification hook behind the PoolRegisteredOps audit counter
int ioengine_stream_fixed_buffers(void* handle) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    return (c && c->use_uring && c->fixed_buffers) ? 1 : 0;
}

// 1 when a live stream submits through an SQPOLL pool ring
int ioengine_stream_sqpoll(void* handle) {
    StreamCtx* c = static_cast<StreamCtx*>(handle);
    return (c && c->pool && c->pool->ring.sqpoll) ? 1 : 0;
}

// 1 if this kernel accepts io_uring_setup (it may be compiled out or
// disabled via the io_uring_disabled sysctl) AND provides EXT_ARG timed
// waits (5.11+), which the engine's interruptible wait loops require
int ioengine_uring_supported() {
    io_uring_params p;
    memset(&p, 0, sizeof(p));
    int fd = sys_io_uring_setup(1, &p);
    if (fd < 0)
        return 0;
    close(fd);
    return (p.features & IORING_FEAT_EXT_ARG) ? 1 : 0;
}

// engine self-description for diagnostics / tests
const char* ioengine_version() {
    return "elbencho-tpu ioengine 11 (sync+aio+uring+fixedbufs+fileloop+blockmods+ratelimit+flock+opslog+stream+deadline+cancel+faultinj+pool+sqpoll)";
}

}  // extern "C"

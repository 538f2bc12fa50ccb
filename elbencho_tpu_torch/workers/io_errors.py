"""Data-plane fault tolerance: storage-error classifier + per-op retry.

Reference: elbencho_tpu/workers/io_errors.py, with the retry shape of
elbencho_tpu/service/fault_tolerance.py (``RetryPolicy``,
``RetryBudget``) copied in: the port has no service mode yet, so only
what the retrier uses. A transient storage hiccup (``EINTR``, ``EAGAIN``,
``ETIMEDOUT``, a short read, ``EIO`` on a network file system) no longer
aborts a whole phase when ``--ioretries`` is given, while a permanent
condition (``ENOSPC``, ``EROFS``, ``EBADF``, ...) still fails fast.

Classifier table:

==============  ===========  =============================================
error           class        rationale
==============  ===========  =============================================
EINTR           transient    interrupted syscall; retry is the POSIX idiom
EAGAIN          transient    transient resource pressure
ETIMEDOUT       transient    per-op deadline (--iotimeout) or netfs timeout
short read/wr   transient    racing truncation/eof settles, netfs hiccup
EIO on netfs    transient    NFS/FUSE/parallel-fs transport errors surface
                             as EIO; local-disk EIO stays permanent
ESTALE/EREMOTEIO transient   stale NFS handle / remote I/O hiccup
ENOSPC EROFS    permanent    retrying cannot create space / writability
EBADF EINVAL    permanent    programming/setup error
ENOENT EACCES   permanent    namespace/permission problems don't heal
everything else permanent    fail-fast default (classify-by-allowlist)
==============  ===========  =============================================

Retry shape: ``--ioretries N`` attempts on top of the first try, jittered
exponential backoff, all backoff drawing from one per-phase
``--ioretrybudget`` seconds account, so a dying device converges to an
error instead of retrying forever. The default of 0 retries keeps the
fail-fast behaviour and its messages as they were.
"""

from __future__ import annotations

import errno
import os
import random
import time
from dataclasses import dataclass

#: always-transient errnos (see the classifier table above)
TRANSIENT_ERRNOS = frozenset({
    errno.EINTR, errno.EAGAIN, errno.ETIMEDOUT, errno.ESTALE,
    getattr(errno, "EREMOTEIO", 121),
})

#: errnos that are never retried, even on a network filesystem
PERMANENT_ERRNOS = frozenset({
    errno.ENOSPC, errno.EROFS, errno.EBADF, errno.EDQUOT, errno.EINVAL,
    errno.ENOENT, errno.EACCES, errno.EPERM, errno.EISDIR, errno.ENOTDIR,
})

#: /proc/mounts fstypes treated as network/parallel filesystems, where
#: EIO usually means a transport hiccup rather than dying media
NETFS_TYPES = frozenset({
    "nfs", "nfs4", "cifs", "smb3", "smbfs", "9p", "afs", "ceph",
    "lustre", "beegfs", "gpfs", "glusterfs", "panfs", "pvfs2",
    "virtiofs", "fuse", "fuse.gcsfuse", "fuse.s3fs", "fuse.sshfs",
    "fuse.juicefs",
})

_mount_cache: "dict[str, bool] | None" = None


@dataclass(frozen=True)
class RetryPolicy:
    """Per-op retry shape (--ioretries / --ioretrybudget)."""

    num_retries: int = 3         # retries per op on top of attempt 1
    budget_secs: float = 30.0    # per-phase backoff-sleep budget
    base_delay_secs: float = 0.05
    max_delay_secs: float = 2.0

    def backoff_delay(self, attempt: int, rng: random.Random) -> float:
        """Jittered exponential backoff: 2^attempt growth, 0.5x-1.5x
        jitter."""
        base = min(self.base_delay_secs * (2 ** attempt),
                   self.max_delay_secs)
        return base * (0.5 + rng.random())


class RetryBudget:
    """Per-phase backoff-time account: every retry of a phase draws from
    it, so many individually cheap retries against a dying device still
    converge to an error within --ioretrybudget seconds."""

    def __init__(self, budget_secs: float):
        self.budget_secs = budget_secs
        self.spent_secs = 0.0

    def reset(self) -> None:
        self.spent_secs = 0.0

    def try_spend(self, delay_secs: float) -> bool:
        if self.spent_secs + delay_secs > self.budget_secs:
            return False
        self.spent_secs += delay_secs
        return True


class ShortIOError(OSError):
    """A read/write moved fewer bytes than requested: transient (racing
    truncation settles; netfs hiccups heal). Its text is the block loops'
    short-I/O error text, so the output of ``--ioretries 0`` is what it
    was before retries existed."""

    def __init__(self, is_read: bool, offset: int, got: int, want: int):
        self.is_read = is_read
        self.offset = offset
        self.got = got
        self.want = want
        super().__init__(errno.EIO,
                         f"short {'read' if is_read else 'write'} at "
                         f"offset {offset}: {got} != {want}")

    def __str__(self) -> str:
        return (f"short {'read' if self.is_read else 'write'} at "
                f"offset {self.offset}: {self.got} != {self.want}")


def _load_netfs_mounts() -> "list[tuple[str, bool]]":
    """[(mountpoint, is_netfs)] sorted longest-mountpoint-first so a
    longest-prefix match resolves nested mounts correctly."""
    mounts: "list[tuple[str, bool]]" = []
    try:
        with open("/proc/self/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                mnt = parts[1].replace("\\040", " ")
                fstype = parts[2]
                is_net = (fstype in NETFS_TYPES
                          or fstype.split(".", 1)[0] == "fuse")
                mounts.append((mnt, is_net))
    except OSError:
        pass
    mounts.sort(key=lambda m: len(m[0]), reverse=True)
    return mounts


def is_netfs_path(path: str) -> bool:
    """Whether path lives on a network/parallel filesystem (longest
    mountpoint prefix match over /proc/self/mounts, cached)."""
    global _mount_cache
    if not path:
        return False
    if _mount_cache is None:
        _mount_cache = {}
    path = os.path.abspath(path)
    hit = _mount_cache.get(path)
    if hit is not None:
        return hit
    result = False
    for mnt, is_net in _load_netfs_mounts():
        if path == mnt or path.startswith(mnt.rstrip("/") + "/") \
                or mnt == "/":
            result = is_net
            break
    _mount_cache[path] = result
    return result


def reset_netfs_cache() -> None:
    global _mount_cache
    _mount_cache = None


def classify_io_error(err: BaseException, path: str = "",
                      netfs: "bool | None" = None) -> str:
    """'transient' (a retry plausibly succeeds) or 'permanent' (abort
    now). netfs overrides the path-based network-filesystem detection."""
    if isinstance(err, ShortIOError):
        return "transient"
    if not isinstance(err, OSError) or err.errno is None:
        return "permanent"
    if err.errno in PERMANENT_ERRNOS:
        return "permanent"
    if err.errno in TRANSIENT_ERRNOS:
        return "transient"
    if err.errno == errno.EIO:
        on_net = netfs if netfs is not None else is_netfs_path(path)
        return "transient" if on_net else "permanent"
    return "permanent"


class IoRetryBudgetExhausted(Exception):
    """Internal: the per-phase backoff budget ran dry; the caller
    re-raises the original storage error."""


class IoRetrier:
    """Per-worker retry driver for storage ops. Counts every retry into
    the worker's ``io_retries``/``io_retry_usec`` counters (the record's
    IoRetries/IoRetryUsec) and checks the worker's interruption flag
    between backoff slices, so a stop or a time limit takes effect even
    mid-backoff."""

    #: backoff sleep slice so interrupts are noticed promptly
    _SLEEP_SLICE_SECS = 0.1

    def __init__(self, worker, policy: RetryPolicy):
        self.worker = worker
        self.policy = policy
        self.budget = RetryBudget(policy.budget_secs)
        # deterministic per-rank jitter stream (reproducible chaos runs)
        self._rng = random.Random(worker.rank)
        self._consec = 0

    def reset(self) -> None:
        """Per-phase reset (the budget is a per-phase account)."""
        self.budget.reset()
        self._consec = 0

    def should_retry(self, err: BaseException, path: str = "",
                     netfs: "bool | None" = None,
                     attempt: "int | None" = None) -> bool:
        """attempt: explicit per-op retry count for callers that
        interleave many in-flight ops (the fused ring), where the shared
        consecutive counter would let one op's retries use up (or
        another op's success reset) a sibling's allowance."""
        if self.policy.num_retries <= 0:
            return False
        done = self._consec if attempt is None else attempt
        if done >= self.policy.num_retries:
            return False
        return classify_io_error(err, path, netfs) == "transient"

    def note_success(self) -> None:
        self._consec = 0

    def backoff(self, attempt: "int | None" = None) -> None:
        """One jittered backoff sleep drawn from the per-phase budget;
        raises IoRetryBudgetExhausted when the budget cannot cover it
        (the caller then re-raises the original error)."""
        done = self._consec if attempt is None else attempt
        delay = self.policy.backoff_delay(done, self._rng)
        if not self.budget.try_spend(delay):
            raise IoRetryBudgetExhausted(
                f"--ioretrybudget exhausted: {self.budget.spent_secs:.1f}s "
                f"of I/O retry backoff already spent this phase")
        if attempt is None:
            self._consec += 1
        self.worker.io_retries += 1
        self.worker.io_retry_usec += int(delay * 1_000_000)
        remaining = delay
        while remaining > 0:
            self.worker.check_interruption_flag_only()
            slice_ = min(self._SLEEP_SLICE_SECS, remaining)
            time.sleep(slice_)
            remaining -= slice_

    def run(self, op, path: str = "", netfs: "bool | None" = None):
        """Run op() with transient-error retries. The final failure
        re-raises the ORIGINAL error, so exhausted retries fail with the
        text ``--ioretries 0`` would have shown."""
        while True:
            try:
                result = op()
            except Exception as err:  # noqa: BLE001 - classified below
                if not self.should_retry(err, path, netfs):
                    raise
                try:
                    self.backoff()
                except IoRetryBudgetExhausted:
                    raise err from None
                continue
            self.note_success()
            return result


def make_io_retrier(worker) -> "IoRetrier | None":
    """The worker's retrier from --ioretries/--ioretrybudget (None when
    retries are off: the loops then take no retry branch at all)."""
    cfg = worker.cfg
    if cfg.io_num_retries <= 0:
        return None
    policy = RetryPolicy(num_retries=cfg.io_num_retries,
                         budget_secs=max(cfg.io_retry_budget_secs, 0))
    return IoRetrier(worker, policy)

"""Benchmark phase model.

Reference: enum BenchPhase + PHASENAME_* (source/Common.h:141-198,43-74),
TranslatorTk::benchPhaseToPhaseName/EntryType, and the master phase ordering
table in Coordinator::runBenchmarks() (source/Coordinator.cpp:311-334) —
creates run before deletes, S3 metadata phases interleave around them.
"""

from __future__ import annotations

import enum


class BenchPhase(enum.IntEnum):
    IDLE = 0
    TERMINATE = 1
    CREATEDIRS = 2
    DELETEDIRS = 3
    CREATEFILES = 4
    DELETEFILES = 5
    READFILES = 6
    SYNC = 7
    DROPCACHES = 8
    STATFILES = 9
    STATDIRS = 10
    LISTOBJECTS = 11
    LISTOBJPARALLEL = 12
    MULTIDELOBJ = 13
    PUTOBJACL = 14
    GETOBJACL = 15
    PUTBUCKETACL = 16
    GETBUCKETACL = 17
    GET_OBJ_MD = 18
    PUT_OBJ_MD = 19
    DEL_OBJ_MD = 20
    GET_BUCKET_MD = 21
    PUT_BUCKET_MD = 22
    DEL_BUCKET_MD = 23
    S3MPUCOMPLETE = 24
    NETBENCH = 25
    TPUBENCH = 26  # TPU-native: host<->HBM / ICI transfer benchmark
    TPUSLICE = 27  # pod-slice: sharded storage ingest + ICI redistribution


# human-readable phase names (reference: PHASENAME_*, Common.h:43-74)
PHASE_NAMES = {
    BenchPhase.IDLE: "IDLE",
    BenchPhase.TERMINATE: "QUIT",
    BenchPhase.CREATEDIRS: "MKDIRS",
    BenchPhase.DELETEDIRS: "RMDIRS",
    BenchPhase.CREATEFILES: "WRITE",
    BenchPhase.DELETEFILES: "RMFILES",
    BenchPhase.READFILES: "READ",
    BenchPhase.SYNC: "SYNC",
    BenchPhase.DROPCACHES: "DROPCACHE",
    BenchPhase.STATFILES: "STAT",
    BenchPhase.STATDIRS: "STATDIRS",
    BenchPhase.LISTOBJECTS: "LISTOBJ",
    BenchPhase.LISTOBJPARALLEL: "LISTOBJ_P",
    BenchPhase.MULTIDELOBJ: "MULTIDEL",
    BenchPhase.PUTOBJACL: "PUTOBJACL",
    BenchPhase.GETOBJACL: "GETOBJACL",
    BenchPhase.PUTBUCKETACL: "PUTBACL",
    BenchPhase.GETBUCKETACL: "GETBACL",
    BenchPhase.GET_OBJ_MD: "GETOBJMD",
    BenchPhase.PUT_OBJ_MD: "PUTOBJMD",
    BenchPhase.DEL_OBJ_MD: "DELOBJMD",
    BenchPhase.GET_BUCKET_MD: "GETBUCKETMD",
    BenchPhase.PUT_BUCKET_MD: "PUTBUCKETMD",
    BenchPhase.DEL_BUCKET_MD: "DELBUCKETMD",
    BenchPhase.S3MPUCOMPLETE: "MPUCOMPL",
    BenchPhase.NETBENCH: "NETBENCH",
    BenchPhase.TPUBENCH: "TPUBENCH",
    BenchPhase.TPUSLICE: "TPUSLICE",
}

#: phases the run journal (--journal) does NOT record: the sync/dropcaches
#: interleave is cheap, idempotent, and its effect (kernel cache state)
#: does not survive a crash anyway — a --resume re-runs it around the
#: first re-run phase instead of trusting stale records. Scenario plans
#: (--scenario) route their explicit sync/dropcaches legs through the
#: same set: a coldwarm resume must never replay a cache drop as
#: "finished work" (scenarios/plan.py ScenarioPlan.resume_runs decides
#: when such a leg re-executes: exactly when its following journaled
#: step does).
UNJOURNALED_PHASES = frozenset({
    BenchPhase.IDLE, BenchPhase.TERMINATE,
    BenchPhase.SYNC, BenchPhase.DROPCACHES,
})

#: phases whose workers drive the device data path (H2D staging on reads,
#: device-originated fills on writes, the transfer bench itself, the
#: slice phase's ingest and redistribution), each traced under
#: --gpuprofile; metadata phases never touch the device
GPU_PROFILE_PHASES = (BenchPhase.CREATEFILES, BenchPhase.READFILES,
                      BenchPhase.TPUBENCH, BenchPhase.TPUSLICE)


# bucket-flavored names used in S3 mode (reference: MKBUCKETS/RMBUCKETS/...)
PHASE_NAMES_S3 = {
    BenchPhase.CREATEDIRS: "MKBUCKETS",
    BenchPhase.DELETEDIRS: "RMBUCKETS",
    BenchPhase.DELETEFILES: "RMOBJECTS",
    BenchPhase.STATFILES: "HEADOBJ",
}


class BenchPathType(enum.IntEnum):
    """Reference: enum BenchPathType, Common.h:200-207."""
    DIR = 0
    FILE = 1
    BLOCKDEV = 2


def phase_name(phase: BenchPhase, s3_mode: bool = False) -> str:
    if s3_mode and phase in PHASE_NAMES_S3:
        return PHASE_NAMES_S3[phase]
    return PHASE_NAMES[phase]


def phase_entry_type(phase: BenchPhase, s3_mode: bool = False) -> str:
    """"dirs"/"files"/"buckets"/"objects" for the given phase
    (reference: TranslatorTk::benchPhaseToPhaseEntryType)."""
    dir_phases = {BenchPhase.CREATEDIRS, BenchPhase.DELETEDIRS,
                  BenchPhase.STATDIRS, BenchPhase.PUTBUCKETACL,
                  BenchPhase.GETBUCKETACL, BenchPhase.PUT_BUCKET_MD,
                  BenchPhase.GET_BUCKET_MD, BenchPhase.DEL_BUCKET_MD}
    if phase in dir_phases:
        return "buckets" if s3_mode else "dirs"
    return "objects" if s3_mode else "files"


class BenchMode(enum.IntEnum):
    """Reference: enum BenchMode, Common.h:148-156."""
    UNDEFINED = 0
    POSIX = 1
    S3 = 2
    HDFS = 3
    NETBENCH = 4

"""Coordinator: benchmark phase ordering of a local run.

Reference: elbencho_tpu/coordinator.py (source/Coordinator.{h,cpp}),
local role only: prepare the workers, run --iterations times the ordered
phases (runBenchmarks :299) with --phasedelay between them, each bracketed
by a --gpuprofile trace where it touches the device and timed for
--timelimit, show its live statistics while it runs, print and write its
results, tear down. SIGINT and SIGTERM shut down in two stages
(:940-978).
"""

from __future__ import annotations

import os
import signal
import sys
import time

from .phases import GPU_PROFILE_PHASES, BenchPhase
from .stats.statistics import Statistics
from .toolkits import logger
from .workers.manager import WorkerManager
from .workers.shared import WorkerException

#: idle host time at each end of a --gpuprofile window: the profiler keeps
#: only device records whose times, converted to the host clock, lie
#: inside the window, and a record at an edge was seen to go missing
PROFILE_MARGIN_S = 0.05


class Coordinator:
    def __init__(self, cfg):
        self.cfg = cfg
        self.manager = WorkerManager(cfg)
        self.statistics = Statistics(cfg, self.manager)
        self._profile_seq = 0  # numbers the traces across iterations
        self._interrupted = False
        self._old_handlers = []  # (signum, previous handler) pairs

    def main(self) -> int:
        self._install_signal_handler()
        try:
            self.manager.prepare_threads()
            self.run_benchmarks()
            return 0
        except WorkerException as err:
            logger.log_error(f"Aborting due to worker error: {err}")
            self.manager.interrupt_and_notify_workers()
            self.statistics.abort_cleanup()
            return 1
        except OSError as err:
            # e.g. a result file that cannot be written: the run fails
            logger.log_error(f"Aborting: {err}")
            self.manager.interrupt_and_notify_workers()
            return 1
        except KeyboardInterrupt:
            logger.log_error("Interrupted. Shutting down workers...")
            self.manager.shared.request_interrupt()
            self.manager.interrupt_and_notify_workers()
            self.statistics.abort_cleanup()
            return 3
        finally:
            self.statistics.close()  # the terminal leaves cbreak mode
            # the workers drain their device copies and storage rings
            # before their buffers are unregistered and freed
            self.manager.join_all_threads()
            self._restore_signal_handler()

    def run_benchmarks(self) -> None:
        """Iterations x ordered phases (reference: runBenchmarks,
        Coordinator.cpp:299-376)."""
        cfg = self.cfg
        phases = cfg.enabled_phases()
        for iteration in range(cfg.iterations):
            if cfg.iterations > 1:
                logger.log(logger.LOG_NORMAL,
                           f"[Starting iteration {iteration + 1} of "
                           f"{cfg.iterations}...]")
            self.statistics.print_phase_results_table_header()
            for idx, phase in enumerate(phases):
                self.run_benchmark_phase(phase)
                if idx < len(phases) - 1 and cfg.next_phase_delay_secs:
                    time.sleep(cfg.next_phase_delay_secs)

    def run_benchmark_phase(self, phase: BenchPhase) -> None:
        """Start phase -> live stats -> wait done (the time limit counts
        from the start) -> print results (reference: runBenchmarkPhase,
        Coordinator.cpp:249). After a signal the interrupted phase's
        results are printed, then the run aborts."""
        phase_start = time.monotonic()
        profiler = self._start_gpu_profile(phase)
        try:
            self.manager.start_next_phase(phase)
            self.statistics.live_stats_loop(phase, phase_start)
            self.manager.wait_for_workers_done(phase_start)
        finally:
            if profiler is not None:
                self._stop_gpu_profile(*profiler)
        self.statistics.print_phase_results(phase)
        if self._interrupted:
            raise KeyboardInterrupt

    def _install_signal_handler(self) -> None:
        """Two-stage shutdown: the first SIGINT or SIGTERM interrupts the
        workers and lets the run unwind (the phase's results, then exit
        code 3); a second one restores the default action and delivers
        itself again."""

        def handler(signum, frame):
            if self._interrupted:
                for sig in (signal.SIGINT, signal.SIGTERM):
                    signal.signal(sig, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
                return
            self._interrupted = True
            print("Interrupt received. Finishing up... "
                  "(send the signal again to force quit)", file=sys.stderr)
            self.manager.shared.request_interrupt()
            self.manager.interrupt_and_notify_workers()

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                self._old_handlers.append((sig, signal.signal(sig, handler)))
            except ValueError:
                pass  # not the main thread: no handler

    def _restore_signal_handler(self) -> None:
        for sig, old in self._old_handlers:
            if old is not None:  # None: a handler not set from Python
                signal.signal(sig, old)
        self._old_handlers = []

    def _start_gpu_profile(self, phase: BenchPhase):
        """--gpuprofile DIR: bracket each device-touching phase with a
        torch.profiler trace (host ops and the CUDA device timeline),
        written as a Chrome trace into one subdirectory per phase run,
        ``DIR/NNN_<phase>``. Returns (profiler, trace dir), or None when
        the phase is not traced or the profiler failed to start."""
        cfg = self.cfg
        if not cfg.gpu_profile_dir:
            return None
        if not (cfg.gpu_ids or cfg.run_gpu_bench or cfg.run_gpu_slice):
            return None
        if phase not in GPU_PROFILE_PHASES:
            return None
        self._profile_seq += 1
        trace_dir = os.path.join(
            cfg.gpu_profile_dir,
            f"{self._profile_seq:03d}_{phase.name.lower()}")
        try:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if cfg.device is None:  # the workers' devices are CUDA GPUs
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(trace_dir, exist_ok=True)
            profiler = profile(activities=activities)
            profiler.start()
        except Exception as err:  # noqa: BLE001 - a failed trace is logged
            logger.log_error(f"--gpuprofile: cannot start torch.profiler "
                             f"trace ({type(err).__name__}: {err})")
            return None
        time.sleep(PROFILE_MARGIN_S)
        logger.log(logger.LOG_NORMAL, f"GPU profile trace: {trace_dir}")
        return profiler, trace_dir

    def _stop_gpu_profile(self, profiler, trace_dir: str) -> None:
        """Wait for the device, close the window and write the trace."""
        try:
            if self.cfg.device is None:
                import torch
                count = torch.cuda.device_count()
                for gpu_id in set(self.cfg.gpu_ids) or range(count):
                    torch.cuda.synchronize(gpu_id % count)
            time.sleep(PROFILE_MARGIN_S)
            profiler.stop()
            profiler.export_chrome_trace(os.path.join(trace_dir,
                                                      "trace.json"))
        except Exception as err:  # noqa: BLE001 - a failed trace is logged
            logger.log_error(f"--gpuprofile: stop_trace failed "
                             f"({type(err).__name__}: {err})")

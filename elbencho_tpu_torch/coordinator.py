"""Coordinator: benchmark phase ordering of a local run.

Reference: elbencho_tpu/coordinator.py (source/Coordinator.{h,cpp}),
local role only: prepare the workers, run the ordered phases
(runBenchmarks :299), each bracketed by a --gpuprofile trace where it
touches the device, print each phase's results, tear down.
"""

from __future__ import annotations

import os
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
        self._profile_seq = 0

    def main(self) -> int:
        try:
            self.manager.prepare_threads()
            self.statistics.print_phase_results_table_header()
            for phase in self.cfg.enabled_phases():
                profiler = self._start_gpu_profile(phase)
                try:
                    self.manager.start_next_phase(phase)
                    self.manager.wait_for_workers_done()
                finally:
                    if profiler is not None:
                        self._stop_gpu_profile(*profiler)
                self.statistics.print_phase_results(phase)
            return 0
        except WorkerException as err:
            logger.log_error(f"Aborting due to worker error: {err}")
            self.manager.interrupt_and_notify_workers()
            return 1
        except KeyboardInterrupt:
            logger.log_error("Interrupted. Shutting down workers...")
            self.manager.shared.request_interrupt()
            self.manager.interrupt_and_notify_workers()
            return 3
        finally:
            self.manager.join_all_threads()

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

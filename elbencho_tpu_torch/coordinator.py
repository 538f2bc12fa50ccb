"""Coordinator: benchmark phase ordering of a local run.

Reference: elbencho_tpu/coordinator.py (source/Coordinator.{h,cpp}),
local role only: prepare the workers, run the ordered phases
(runBenchmarks :299), print each phase's results, tear down.
"""

from __future__ import annotations

from .stats.statistics import Statistics
from .toolkits import logger
from .workers.manager import WorkerManager
from .workers.shared import WorkerException


class Coordinator:
    def __init__(self, cfg):
        self.cfg = cfg
        self.manager = WorkerManager(cfg)
        self.statistics = Statistics(cfg, self.manager)

    def main(self) -> int:
        try:
            self.manager.prepare_threads()
            self.statistics.print_phase_results_table_header()
            for phase in self.cfg.enabled_phases():
                self.manager.start_next_phase(phase)
                self.manager.wait_for_workers_done()
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

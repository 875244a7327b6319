"""Heterogeneous pipeline trainer: host sections feeding device sections.

Port of ``paddle_tpu.parallel.heter_pipeline`` (the reference's
``HeterPipelineTrainer`` / ``HeterSectionWorker``,
framework/heter_pipeline_trainer.cc, heter_section_worker.cc, and the
heter RPC between CPU trainers and device workers). A section is a
Python callable, host code or a step on the card; sections are joined by
bounded queues (the reference's send/recv variable queues, capacity =
micro-batch credit). Each section runs ``num_threads`` workers (a
HeterSectionWorker thread pool); order across a section with more than
one thread is not kept, as in the reference. The first error raised in
any section is re-raised by ``run`` once every worker has drained, so a
failing section never hangs the pipeline. Across processes, a section
reads from or writes to a ``parallel.heter_channel`` channel.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..core.enforce import enforce

__all__ = ["SectionConfig", "HeterPipelineTrainer"]

_STOP = object()


@dataclasses.dataclass
class SectionConfig:
    """One pipeline section (the trainer-desc section_param analogue):
    ``fn(item) -> item`` transforms a micro-batch; ``place`` is
    documentation of where it runs ("cpu" host code, "gpu" the card);
    ``num_threads`` = concurrent workers (HeterSectionWorker
    num_microbatches concurrency)."""

    fn: Callable[[Any], Any]
    place: str = "cpu"
    num_threads: int = 1


class HeterPipelineTrainer:
    """Drive micro-batches through heterogeneous sections.

    ``run(source)`` streams every item from ``source`` through all
    sections and returns the final section's outputs (order preserved
    only when every section has num_threads=1, like the reference's
    single-worker sections).
    """

    def __init__(self, sections: Sequence[SectionConfig],
                 channel_capacity: int = 8) -> None:
        enforce(len(sections) >= 1, "need at least one section")
        for s in sections:
            enforce(s.num_threads >= 1, "num_threads >= 1")
        self.sections = list(sections)
        self.capacity = channel_capacity
        #: the last run's (start, end) ``time.perf_counter`` of each call of
        #: each section's fn, by section (the sections' busy spans)
        self.spans: List[List[Tuple[float, float]]] = []

    def run(self, source, collect: bool = True) -> Optional[List[Any]]:
        n_sec = len(self.sections)
        chans: List[queue.Queue] = [queue.Queue(self.capacity) for _ in range(n_sec + 1)]
        errors: List[BaseException] = []
        err_lock = threading.Lock()
        spans: List[List[Tuple[float, float]]] = [[] for _ in range(n_sec)]
        self.spans = spans

        def worker(sec_idx: int) -> None:
            sec = self.sections[sec_idx]
            inq, outq = chans[sec_idx], chans[sec_idx + 1]
            failed = False
            while True:
                item = inq.get()
                if item is _STOP:
                    inq.put(_STOP)  # release sibling threads of this section
                    break
                if failed or errors:
                    continue  # drain so upstream puts can't deadlock
                try:
                    t0 = time.perf_counter()
                    out = sec.fn(item)
                    spans[sec_idx].append((t0, time.perf_counter()))
                    outq.put(out)
                except BaseException as e:  # noqa: BLE001 — surfaced in run()
                    with err_lock:
                        errors.append(e)
                    failed = True

        threads = []
        for i, sec in enumerate(self.sections):
            for _ in range(sec.num_threads):
                t = threading.Thread(target=worker, args=(i,), daemon=True,
                                     name=f"heter-stage-{i}")
                t.start()
                threads.append(t)

        results: List[Any] = [] if collect else None
        sink_done = threading.Event()

        def sink() -> None:
            while True:
                item = chans[n_sec].get()
                if item is _STOP:
                    break
                if collect:
                    results.append(item)
            sink_done.set()

        sink_thread = threading.Thread(target=sink, daemon=True,
                                       name="heter-sink")
        sink_thread.start()

        # feed
        fed = 0
        for item in source:
            if errors:
                break
            chans[0].put(item)
            fed += 1
        chans[0].put(_STOP)

        # join stage by stage: once every worker of section i exited, no
        # more items can reach section i+1 — forward the stop marker
        ti = 0
        for i, sec in enumerate(self.sections):
            for _ in range(sec.num_threads):
                threads[ti].join()
                ti += 1
            chans[i + 1].put(_STOP)
        sink_done.wait()

        if errors:
            raise errors[0]
        return results

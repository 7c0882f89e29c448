"""Stateful, checkpointable data iterator (counterpart of
``repro/data/pipeline.py``).

The iterator's state is two integers ``(seed, step)`` because batches are
pure functions of them, so a restart resumes at the same batch.
``prefetch`` makes the next batches on a helper thread while the step runs;
an error there is raised by the ``next`` call that would have taken the
batch.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterator, NamedTuple, Optional


class IteratorState(NamedTuple):
    seed: int
    step: int


@dataclasses.dataclass
class DataIterator:
    """Wraps a ``batch_fn(step, batch_size) -> batch`` generator."""

    batch_fn: Callable[[int, int], Any]
    batch_size: int
    state: IteratorState = IteratorState(seed=0, step=0)
    prefetch: int = 2

    def __post_init__(self):
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def get_state(self) -> IteratorState:
        return self.state

    def set_state(self, state: IteratorState) -> None:
        self._shutdown()
        self.state = IteratorState(int(state.seed), int(state.step))

    def _producer(self, step: int, q: queue.Queue):
        while not self._stop.is_set():
            try:
                batch = self.batch_fn(step, self.batch_size)
            except Exception as e:  # hand it to the consumer instead of hanging it
                batch = e
            while not self._stop.is_set():
                try:
                    q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> Any:
        if self.prefetch > 0:
            if self._thread is None:
                self._stop.clear()
                self._q = queue.Queue(maxsize=self.prefetch)
                self._thread = threading.Thread(
                    target=self._producer, args=(self.state.step, self._q), daemon=True)
                self._thread.start()
            step, batch = self._q.get()
            if isinstance(batch, Exception):
                self._shutdown()
                raise batch
        else:
            step, batch = self.state.step, self.batch_fn(self.state.step, self.batch_size)
        self.state = IteratorState(self.state.seed, step + 1)
        return batch

    def __iter__(self) -> Iterator[Any]:
        return self

    def _shutdown(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
        self._thread = None
        self._q = None

    def close(self):
        self._shutdown()

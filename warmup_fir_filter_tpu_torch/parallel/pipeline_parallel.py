"""Pipeline parallelism: DSP-chain stages on distinct devices.

Counterpart of ``warmup_fir_filter_tpu/parallel/pipeline_parallel.py``.
The DSP chain (resample → channelize → demod) is a linear stage graph:
here each stage is a callable placed on a torch device, and a stream of
microbatches flows through the stages in the classic 1F schedule.

- **Interleaved tick submission**: at tick ``t`` the executor submits
  stage ``s`` of microbatch ``t - s`` for every stage, deepest stage
  first.  On CUDA each stage runs on its own ``torch.cuda.Stream`` and an
  event recorded after each stage carries the dependency to the next, so
  the host never waits for a stage to enqueue the next one and stages of
  different microbatches run concurrently where the card has room.
- **Bounded in-flight window**: at most ``max_in_flight`` microbatches
  may be between submission and retirement; beyond that the executor
  blocks on the oldest retirement's event.  Retirement copies the output
  to the host, which caps device activations at ``O(window · stages)``.

On the CPU the stages run in order, with the same results.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build


class PipelinedChain:
    """Run a linear chain of stage functions across a device list."""

    def __init__(
        self,
        stages: Sequence[Callable],
        devices: Sequence[torch.device | str] | None = None,
    ):
        if not stages:
            raise ValueError("stages must not be empty")
        if devices is None:
            _build.resolve_device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        available = [torch.device(d) for d in devices]
        if not available:
            raise ValueError("no devices available")
        self._devices = [
            available[i % len(available)] for i in range(len(stages))
        ]
        self._stages = list(stages)

    @property
    def placements(self) -> list[torch.device]:
        return list(self._devices)

    def run_microbatches(
        self,
        microbatches: Sequence,
        *,
        max_in_flight: int | None = None,
        force_sequential: bool = False,
    ) -> list:
        """Push all microbatches through the pipeline; returns the outputs
        as host tensors, in order.

        Args:
            microbatches: inputs to stage 0, processed in order.
            max_in_flight: bound on microbatches between submission and
                retirement (default ``len(stages) + 1``).  Beyond the bound
                the executor blocks on the oldest output.
            force_sequential: synchronize after every stage (defeats all
                overlap), so that the pipelining gain is measured, not
                assumed.
        """
        num_stages = len(self._stages)
        num_batches = len(microbatches)
        if max_in_flight is None:
            max_in_flight = num_stages + 1
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                   for d in self._devices]
        for stream in streams:
            if stream is not None:  # inputs the caller queued come first
                stream.wait_stream(torch.cuda.current_stream(stream.device))

        # state[m] = (activation, event) of microbatch m after its last
        # submitted stage; done holds retired-stage outputs in order.
        state: dict[int, tuple] = {}
        done: deque[tuple[int, torch.Tensor, object]] = deque()
        results: list = [None] * num_batches

        def _retire_oldest() -> None:
            m, value, event = done.popleft()
            if event is not None:
                event.synchronize()
            results[m] = value.cpu()

        for tick in range(num_batches + num_stages - 1):
            for s in reversed(range(num_stages)):
                m = tick - s
                if not (0 <= m < num_batches):
                    continue
                if s == 0:
                    # Admission: enforce the in-flight bound first.
                    while len(state) + len(done) >= max_in_flight:
                        if done:
                            _retire_oldest()
                        else:  # window smaller than pipeline depth:
                            # wait for the oldest in-flight activation.
                            event = state[min(state)][1]
                            if event is not None:
                                event.synchronize()
                            break
                    value, event = microbatches[m], None
                else:
                    value, event = state[m]
                value, event = self._submit(s, value, event, streams[s])
                if force_sequential and event is not None:
                    event.synchronize()
                if s == num_stages - 1:
                    state.pop(m, None)
                    done.append((m, value, event))
                else:
                    state[m] = (value, event)
        while done:
            _retire_oldest()
        return results

    def _submit(self, s: int, value, event, stream):
        """Stage ``s`` on ``value``, after ``event``, on its device and
        stream; returns the output and the event that marks it."""
        device = self._devices[s]
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        if stream is None:
            return self._stages[s](value.to(device)), None
        with torch.cuda.stream(stream):
            if event is not None:
                stream.wait_event(event)
            value = value.to(device, non_blocking=True)
            value.record_stream(stream)
            out = self._stages[s](value)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

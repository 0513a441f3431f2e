"""K optimizer steps a dispatch: the port's counterpart of the JAX package's
``make_multi_train_step`` (K steps as one ``lax.scan`` in one XLA program).

On the card a dispatch is one replay of a CUDA graph captured over K
unrolled :func:`~.training.train_step` calls. The K batches and their
augmentation draws are copied into static buffers, the graph replays every
kernel of the K steps (the epipolar, NMS and ROIAlign kernels among them)
with no host launch of its own, and its static outputs hold the K steps'
mean metrics and the last step's aux until the next dispatch. On the CPU
the K steps run in turn.

What the capture needs, and how it is met:

* the step makes no host sync and copies nothing from pageable memory: its
  constants are built on the device once, and Adam keeps its count, LR and
  skip decision there;
* the graph holds the address of every parameter, Adam buffer, BatchNorm
  buffer and static input, so all of them are updated in place and never
  rebound (``Adam.load_state_dict`` and ``Module.load_state_dict`` copy);
  a tensor rebound after the capture leaves the graph reading stale memory;
* the eager warm-up that capture needs (cuDNN and cuBLAS workspaces,
  autograd's lazy init) trains: the state it changes is saved before it and
  restored in place after, so the first dispatch equals K eager steps from
  the state the caller held;
* the kernels' launch counters count at capture, where nothing runs: the
  capture's counts are taken back, and each replay adds them.
* with a process group (data parallelism) the graph holds each step's
  all-reduce: every rank reaches the warm-up and the capture at the same
  dispatch, and the warm-up's all-reduces have set up the communicator
  before the capture records any; NCCL's watchdog thread polls its work
  meanwhile, which ``capture_error_mode="thread_local"`` allows.

A capture that fails raises; a dispatch never falls back to eager steps.
"""

from __future__ import annotations

import time

import torch

from . import training as T
from .ops import epipolar as E
from .ops import nms as N
from .ops import roi_align as RA

# the wrappers' counters that a replay advances: (function, attribute)
COUNTERS = ((E.epipolar_abs_residual_maps, "launches"), (E.epipolar_abs_residual_maps, "maps"),
            (N.nms, "launches"), (RA.multilevel_roi_align, "launches"))
COUNTER_NAMES = ("epipolar_launches", "epipolar_maps", "nms_launches", "roi_align_launches")


def _read_counters() -> list[int]:
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _add_counters(values) -> None:
    for (fn, attr), v in zip(COUNTERS, values):
        setattr(fn, attr, getattr(fn, attr) + v)


class KStepDispatch:
    """``k`` train steps a call on (K, B, …) batches and their draws
    (:func:`~.training.multi_step_draws`; None with ``disable_augment``):
    returns the K steps' mean metrics and the last step's ``LossAux``, and
    keeps each step's metrics in :attr:`step_metrics` ({name: (K,)}). On the
    card the returned tensors are the graph's own outputs: read them before
    the next dispatch. The graph is captured at the first call, or by
    :meth:`capture`; :attr:`capture_seconds` says how long it took."""

    def __init__(self, cfg, models: T.ModelBundle, opt: T.Adam, k: int, provider=None, group=None):
        if k < 1:
            raise ValueError(f"a dispatch takes k >= 1 steps, not {k}")
        self.cfg, self.models, self.opt, self.k, self.provider = cfg, models, opt, k, provider
        self.group = group
        self.device = opt.params[0].device
        self.graph: torch.cuda.CUDAGraph | None = None
        self.capture_seconds: float | None = None
        self.step_metrics: dict | None = None
        self.captured_launches: dict | None = None  # a replay's kernel launches, by counter
        self.replays = 0

    def _check(self, batches: dict, draws: dict | None) -> None:
        n = batches["colors_u8"].shape[0]
        if n != self.k:
            raise ValueError(f"a {self.k}-step dispatch needs {self.k} batches, got {n}")
        if draws is None and not self.cfg.disable_augment:
            raise ValueError("a dispatch needs the K steps' augmentation draws (training.multi_step_draws)")

    def __call__(self, batches: dict, draws: dict | None = None):
        self._check(batches, draws)
        if self.device.type == "cpu":
            metrics, aux, self.step_metrics = T.k_train_steps(self.cfg, self.models, self.opt, batches, draws,
                                                              self.provider, self.group)
            return metrics, aux
        if self.device.type != "cuda":
            raise ValueError(f"unsupported device {self.device}")
        if self.graph is None:
            self.capture(batches, draws)
        self._load(batches, draws)
        self.graph.replay()
        self.replays += 1
        _add_counters(self.captured_launches.values())
        return self._metrics, self._aux

    def _state(self) -> list[torch.Tensor]:
        """Every tensor a step updates in place: the trained params, the
        nets' buffers (BatchNorm statistics) and Adam's state."""
        opt = self.opt
        buffers = [b for m in self.models for b in m.buffers()]
        return ([p.detach() for p in opt.params] + buffers + opt.mu + opt.nu
                + [opt._count, opt.notfinite_count, opt.total_notfinite, opt.last_finite])

    def capture(self, batches: dict, draws: dict | None = None) -> None:
        """Warm up on a side stream with one eager pass of the K steps,
        restore the state it trained, and capture the K steps on static
        copies of ``batches`` and ``draws``."""
        self._check(batches, draws)
        t0 = time.perf_counter()
        self._batches = {key: v.clone() for key, v in batches.items()}
        self._draws = None if draws is None else {key: v.clone() for key, v in draws.items()}
        state = self._state()
        saved = [t.clone() for t in state]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            T.k_train_steps(self.cfg, self.models, self.opt, self._batches, self._draws, self.provider, self.group)
        current.wait_stream(side)
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        del saved
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the loader's and the checkpoint writer's threads
            # may call into CUDA while this thread captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._metrics, self._aux, self.step_metrics = T.k_train_steps(
                    self.cfg, self.models, self.opt, self._batches, self._draws, self.provider, self.group)
        finally:
            launched = [a - b for a, b in zip(_read_counters(), before)]
            _add_counters([-n for n in launched])  # nothing ran at capture
        self.captured_launches = dict(zip(COUNTER_NAMES, launched))
        torch.cuda.synchronize(self.device)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def _load(self, batches: dict, draws: dict | None) -> None:
        if set(batches) != set(self._batches):
            raise ValueError(f"a dispatch of {sorted(batches)} does not fit the captured {sorted(self._batches)}")
        pairs = list(zip(self._batches.values(), (batches[key] for key in self._batches)))
        if draws is not None:
            pairs += list(zip(self._draws.values(), (draws[key] for key in self._draws)))
        for dst, src in pairs:
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"a dispatch input of {tuple(src.shape)} {src.dtype} does not fit the "
                                 f"captured {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src, non_blocking=True)

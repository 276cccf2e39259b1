"""In-process model server for the port: the data plane of a TPUServe pod
whose template names ``tfk8s_tpu_torch.runtime.server:serve``.

A counterpart of the JAX package's ``runtime/server.py`` for the
continuous-batching GPT path:

- :class:`PagedGptDecoder` is the model half: the GPT module and its
  block-paged KV pools on one device (the card unless the caller asks for
  the CPU), behind the ten members the decode loop calls (``load``,
  ``pages_per_slot``, ``max_len``, ``vocab_size``, ``validate``,
  ``prefill_batch``, ``decode``, ``verify``, ``export_kv``,
  ``import_kv``). It runs the packed device steps of ``models/gpt.py`` in
  eager torch; the pools are written in place.
- :class:`DecodeLoopExecutor` (with ``_GenRequest`` and ``_Slot``) is a
  copy of the reference's host half: token-granularity admission and
  retirement, chunked prefill, the prefix cache, priority scheduling with
  page-spill preemption, speculative decode, the KV tiers, fault
  containment, the metric families and spans. Only the seams where the
  reference read a device array with ``np.asarray`` changed: the torch
  decoder already returns host numpy there.
- :class:`ModelServer` is a copy of the reference's slot-per-batch
  executor (the legacy path ``TFK8S_SERVE_DECODE_LOOP=0`` pins), with its
  served models :class:`EchoModel`, :class:`MlpClassifier` and
  :class:`GptGenerator` (batched prefill and KV-cache ``gpt.generate``
  over exact-length prompt buckets) and :func:`make_model`.
- :func:`serve` is the pod entrypoint with the reference's env keys and
  defaults. It reports ``serving_ready`` through the node agent's
  progress sink and raises the node agent's ``PodDrained`` on a reclaim
  notice (``runtime/node_agent``), so the control plane sees a port
  replica become Ready and drain like a reference one.

Replicas register in this module's own table (:func:`lookup_replica`),
where the port's gateway (``gateway/server.py``) and :class:`ServeClient`
route to them and whose drain hooks (:func:`add_drain_hook`) fire when
one unregisters. Under a foreign node agent they register in the agent's
serving table too, wrapped so that they speak its error and buffer types
(``runtime/agent_replica``): that agent's gateway routes to them there,
and its table fires its own gateway's hooks. The control-plane helpers
(:func:`replica_is_ready`, :func:`template_hash`,
:func:`jittered_backoff`) are the reference's.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from tfk8s_tpu_torch.obs import trace as _trace
from tfk8s_tpu_torch.runtime import node_agent
from tfk8s_tpu_torch.runtime import progress as _progress
from tfk8s_tpu_torch.runtime.handoff import HandoffError, KVHandoffBuffer
from tfk8s_tpu_torch.runtime.launcher import select_device
from tfk8s_tpu_torch.utils.logging import Metrics, get_logger

log = get_logger("serve")

# Per-token timeline events attached to a traced request's serve span
# are strided down to this many samples.
MAX_TOKEN_EVENTS = 32


def _trace_id_of(traceparent: str) -> str:
    parsed = _trace.parse_traceparent(traceparent)
    return parsed[0] if parsed else ""


def _host(x: Any) -> np.ndarray:
    """A host numpy copy of a device tensor (numpy passes through)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)




class ServeError(Exception):
    """Base class for serving-path errors."""


class Overloaded(ServeError):
    """Bounded-queue backpressure: the request was shed, not queued — the
    typed 429 equivalent. Carries the observed depth and the limit so a
    client/load-balancer can back off intelligently; ``retry_after_s``
    (when the shedder knows one — the gateway's priority bands do) is the
    hint clients turn into a jittered backoff instead of re-hammering."""

    def __init__(self, queue_depth: int, queue_limit: int,
                 retry_after_s: Optional[float] = None):
        self.queue_depth = queue_depth
        self.queue_limit = queue_limit
        self.retry_after_s = retry_after_s
        super().__init__(
            f"request queue full ({queue_depth}/{queue_limit}); retry later"
        )


class QuotaExceeded(ServeError):
    """The TENANT's admission budget (gateway/admission.py: token-bucket
    QPS or the concurrency cap from its TenantQuota) is exhausted — the
    per-tenant 429. Distinct from :class:`Overloaded`: the cluster may
    have headroom; THIS tenant does not, which is what keeps one abusive
    tenant from starving the rest. ``retry_after_s`` is when the bucket
    accrues the next token."""

    def __init__(self, tenant: str, retry_after_s: float, reason: str = "qps"):
        self.tenant = tenant
        self.retry_after_s = retry_after_s
        self.reason = reason
        super().__init__(
            f"tenant {tenant!r} over {reason} quota; retry in {retry_after_s:.3f}s"
        )


class Draining(ServeError):
    """The replica is shutting down (rolling update / scale-down): it no
    longer ACCEPTS requests but will finish the ones it holds. Clients
    retry on another replica."""


class InvalidRequest(ServeError):
    """The request itself is unservable (e.g. prompt + generation budget
    exceeds the model's max_len) — the typed 400 equivalent. Unlike a
    malformed payload (TypeError: caller bug), this is a CLIENT-visible
    outcome: counted as ``outcome="invalid"`` in the serving request
    counter and never retried by :class:`ServeClient` (no other replica
    could serve it either)."""


class RequestFailed(ServeError):
    """The model raised while executing the batch this request rode."""


class DeadlineExceeded(ServeError, TimeoutError):
    """The caller's deadline elapsed before the request was served — the
    typed 504 equivalent. Subclasses :class:`TimeoutError` so callers
    written against the original ``raise TimeoutError`` contract keep
    working, while the serve paths now only raise the ServeError tree."""


class ReplicaUnavailable(RequestFailed, ConnectionError):
    """The replica died (or dropped the connection) while it held the
    request — a transport-class failure of an accepted-but-unanswered,
    idempotent serve request. Unlike a plain :class:`RequestFailed` (the
    request's own execution raised), NOTHING about the request itself is
    suspect: it is safe to re-dispatch to a survivor, which is exactly
    what the gateway does under its retry budget. Subclasses
    :class:`ConnectionError` so transport-level handlers catch it too."""


class RowFault(RequestFailed):
    """A fault attributable to ONE decode row — poisoned pages, a
    malformed continuation (out-of-vocab token off the device), a
    per-row device fault. Crash containment retires THAT row typed and
    quarantines its pages; sibling rows keep decoding untouched."""


class Preempted(RequestFailed):
    """A low-priority row was evicted mid-decode to free KV pages for a
    stalled higher-priority admission AND its spill could not complete
    (an export/serialize failure) — the row cannot be resumed, so its
    request fails typed and retriable. A SUCCESSFUL preemption never
    surfaces this error: the row's KV spills to a host-side
    :class:`KVHandoffBuffer`, the request re-enters the queue at the
    front of its priority class, and it later completes bit-identical to
    an unpreempted run (the resume path is the KV-handoff import). The
    class exists so spill failures are distinguishable from
    :class:`RowFault` (whose pages are suspect) — a preempted-and-lost
    request's pages were healthy; it is safe to re-dispatch."""


# ---------------------------------------------------------------------------
# Request parsing and the served GPT model
# ---------------------------------------------------------------------------


# (temperature, top_k, top_p, seed) — the normalized per-request
# sampling tuple threaded from validate() through the packed device
# step. temperature <= 0 pins the row to the greedy argmax path.
_SamplingTuple = Tuple[float, int, float, int]


def _parse_sampling(raw: Any) -> Optional[_SamplingTuple]:
    """Normalize a payload's ``sampling`` block into ``(temperature,
    top_k, top_p, seed)`` via :class:`api.types.SamplingParams`, the one
    wire schema of the block. Raises :class:`InvalidRequest` on malformed
    blocks and out-of-range knobs; None for greedy."""
    from tfk8s_tpu_torch.api.types import SamplingParams

    if raw is None:
        return None
    try:
        params = SamplingParams.from_payload(raw)
    except ValueError as e:
        raise InvalidRequest(str(e)) from None
    if params.temperature == 0.0:
        return None  # greedy: identical to no sampling block at all
    return params.as_tuple()


def _gpt_config_of(size: str):
    """Served GPT shape by name: ``tiny`` (test scale), ``mid`` (the
    serving-bench scale), ``base`` (GPT-2-small)."""
    from tfk8s_tpu_torch.models import gpt

    shapes = {
        "tiny": gpt.tiny_config,
        "mid": gpt.mid_config,
        "base": gpt.base_config,
    }
    if size not in shapes:
        raise ServeError(
            f"unknown TFK8S_SERVE_GPT_SIZE {size!r} (known: tiny, mid, base)"
        )
    return shapes[size]()


def _params_from_checkpoint(checkpoint: str, init_fn: Callable[[int], Any]) -> Any:
    """Resolve a checkpoint ref to a model ``state_dict``: ``seed:<n>``
    initializes deterministically from torch's generator (so the same
    seed gives other weights than the reference's flax init); anything
    else restores the model of the latest committed step of a port
    checkpoint directory (``runtime/checkpoint.py``)."""
    if checkpoint.startswith("seed:"):
        return init_fn(int(checkpoint[len("seed:"):] or "0"))
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

    mgr = Checkpointer(checkpoint)
    if mgr.latest_step() is None:
        raise ServeError(f"checkpoint {checkpoint!r} has no saved step")
    return mgr.restore()["model"]


class ServedModel:
    """One loadable model family of the slot-per-batch executor
    (:class:`ModelServer`; reference ``server.py:169``). ``bucket_of``
    partitions payloads into batchable groups (payloads in one bucket must
    stack after the model's own padding); ``forward`` serves one bucket's
    batch."""

    #: version string of the loaded weights (the checkpoint ref)
    version: str = ""

    def load(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def bucket_of(self, payload: Any) -> Any:  # pragma: no cover - interface
        raise NotImplementedError

    def forward(self, payloads: List[Any]) -> List[Any]:  # pragma: no cover
        raise NotImplementedError


class EchoModel(ServedModel):
    """The control plane's test model (reference ``server.py:187``): no
    device, no weights. The response echoes ``payload`` and the version;
    ``delay_ms`` stands for a batch's model time, so batching beats
    one-at-a-time dispatch and queue depth builds up under load."""

    def __init__(self, checkpoint: str = "", delay_ms: float = 0.0):
        self.version = checkpoint or "echo"
        self.delay_ms = delay_ms
        self._loaded = False

    def load(self) -> None:
        self._loaded = True

    def bucket_of(self, payload: Any) -> Any:
        shape = getattr(payload, "shape", None)
        return ("echo", tuple(shape) if shape is not None else type(payload).__name__)

    def forward(self, payloads: List[Any]) -> List[Any]:
        if not self._loaded:
            raise RequestFailed("model not loaded")
        if self.delay_ms:
            time.sleep(self.delay_ms / 1000.0)
        return [{"echo": p, "version": self.version} for p in payloads]


def _load_module(module: nn.Module, state: Dict[str, torch.Tensor], dtype: torch.dtype,
                 device: torch.device) -> nn.Module:
    """``state`` into ``module`` on ``device`` for inference, its
    ``nn.Linear`` layers cast to ``dtype`` once (a projection casts its
    weight to ``dtype`` anyway, so the numbers do not change)."""
    module.load_state_dict(state)
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.to(dtype)
    return module.to(device).eval().requires_grad_(False)


class MlpClassifier(ServedModel):
    """The classifier's serving path (reference ``server.py:229``): one
    forward over a batch padded to ``max_batch_size`` rows, the argmax
    label a row, on the card unless ``device`` asks for the CPU."""

    def __init__(self, checkpoint: str, max_batch_size: int, hidden: int = 64,
                 device: Union[str, torch.device, None] = None):
        self.version = checkpoint
        self.max_batch_size = max_batch_size
        self.hidden = hidden
        self._device_arg = device
        self.device: Optional[torch.device] = None
        self.module: Optional[nn.Module] = None

    def load(self) -> None:
        from tfk8s_tpu_torch.models import mlp

        self.device = select_device({}, self._device_arg)

        def init_fn(seed: int):
            model = mlp.MLP(hidden=self.hidden)
            return mlp.init_params(model, torch.Generator().manual_seed(seed)).state_dict()

        self.module = _load_module(mlp.MLP(hidden=self.hidden),
                                   _params_from_checkpoint(self.version, init_fn),
                                   torch.float32, self.device)

    def bucket_of(self, payload: Any) -> Any:
        arr = np.asarray(payload)
        if arr.ndim != 1:
            raise TypeError(f"mlp payload must be a 1-D feature vector, got {arr.shape}")
        return ("mlp", arr.shape)

    @torch.no_grad()
    def forward(self, payloads: List[Any]) -> List[Any]:
        x = np.stack([np.asarray(p, dtype=np.float32) for p in payloads])
        n = len(payloads)
        if n < self.max_batch_size:  # one padded shape for every batch
            x = np.concatenate([x, np.zeros((self.max_batch_size - n, x.shape[1]), np.float32)])
        labels = _host(self.module(torch.from_numpy(x).to(self.device)).argmax(-1))
        return [{"label": int(labels[i]), "version": self.version} for i in range(n)]


class GptGenerator(ServedModel):
    """The slot-per-batch generative path (reference ``server.py:326``):
    batched prefill and KV-cache decode through ``models/gpt.generate``.
    Prompts bucket by exact length, since decode mode refuses padding
    masks; the batch pads to ``max_batch_size`` with row 0 repeated, and
    each bucket's cache holds exactly prompt + generation. ``cfg`` and
    ``device`` override the size preset and the card, as
    :class:`PagedGptDecoder`'s do."""

    def __init__(self, checkpoint: str, max_batch_size: int, gen_tokens: int = 16,
                 size: str = "tiny", cfg: Any = None,
                 device: Union[str, torch.device, None] = None):
        self.version = checkpoint
        self.max_batch_size = max_batch_size
        self.gen_tokens = gen_tokens
        self.size = size
        self._cfg_base = cfg
        self._device_arg = device
        self.device: Optional[torch.device] = None
        self._cfg = None
        self.module: Optional[nn.Module] = None

    def load(self) -> None:
        from tfk8s_tpu_torch.models import gpt
        from tfk8s_tpu_torch.models.transformer import init_params

        self._cfg = self._cfg_base if self._cfg_base is not None else _gpt_config_of(self.size)
        self.device = select_device({}, self._device_arg)

        def init_fn(seed: int):
            model = gpt.GPTLM(self._cfg)
            return init_params(model, torch.Generator().manual_seed(seed)).state_dict()

        self.module = _load_module(gpt.GPTLM(self._cfg),
                                   _params_from_checkpoint(self.version, init_fn),
                                   self._cfg.dtype, self.device)

    @property
    def cfg(self):
        return self._cfg

    def bucket_of(self, payload: Any) -> Any:
        arr = np.asarray(payload)
        if arr.ndim != 1 or arr.dtype.kind not in "iu":
            raise TypeError(
                f"gpt payload must be a 1-D int token array, got {arr.dtype}{arr.shape}"
            )
        if arr.shape[0] + self.gen_tokens > self._cfg.max_len:
            raise InvalidRequest(
                f"prompt of {arr.shape[0]} + {self.gen_tokens} generated "
                f"tokens exceeds max_len={self._cfg.max_len}"
            )
        return ("gpt", int(arr.shape[0]))

    def forward(self, payloads: List[Any]) -> List[Any]:
        from tfk8s_tpu_torch.models import gpt

        prompt = np.stack([np.asarray(p, dtype=np.int32) for p in payloads])
        n, plen = prompt.shape
        if n < self.max_batch_size:  # one batch shape for every bucket
            prompt = np.concatenate(
                [prompt, np.repeat(prompt[:1], self.max_batch_size - n, axis=0)])
        # the cache right-sized to this bucket: prompt + generation
        cfg = dataclasses.replace(self._cfg, decode_cache_len=plen + self.gen_tokens)
        out = _host(gpt.generate(cfg, self.module, torch.from_numpy(prompt).to(self.device),
                                 num_tokens=self.gen_tokens))
        return [{"tokens": out[i].tolist(), "version": self.version} for i in range(n)]


class PagedGptDecoder:
    """Model half of the continuous-batching decode loop: the GPT module
    and its paged KV pools on one device, behind the members the loop
    calls. ``decode`` keeps the packed state on the device and returns
    the emitted tokens as numpy (the loop's one sync a step); every
    other dispatch returns synced numpy, as the reference's does.

    The projection weights are cast to ``cfg.dtype`` once at load (each
    projection casts its weight to ``cfg.dtype`` anyway, so the numbers
    do not change); layer norms and the tied float32 head stay float32.
    ``cfg``/``params`` override the size preset and the checkpoint (a
    ``state_dict``), as the reference's do; ``device`` defaults to the
    card (``launcher.select_device``)."""

    def __init__(self, checkpoint: str, slots: int, page_size: int,
                 max_pages: int, gen_tokens: int = 16, size: str = "tiny",
                 prefill_chunk: int = 32, eos_id: Optional[int] = None,
                 cfg: Any = None, params: Any = None,
                 device: Union[str, torch.device, None] = None):
        self.version = checkpoint
        self.slots = max(1, int(slots))
        self.page_size = max(1, int(page_size))
        self.max_pages = max(2, int(max_pages))
        self.gen_tokens = gen_tokens
        self.size = size
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.eos_id = eos_id
        self._cfg_base = cfg
        self._params_override = params
        self._device_arg = device
        self.device: Optional[torch.device] = None
        self._cfg = None
        # the GPT module (set by load), for callers that run it unpaged
        self.module: Optional[nn.Module] = None
        self._pages = None
        # the last sampling knobs moved to the device, reused while the
        # loop passes the same host arrays (it rebuilds them only when a
        # row changes)
        self._samp_src: Any = None
        self._samp_dev: Any = None

    def load(self) -> None:
        from tfk8s_tpu_torch.models import gpt
        from tfk8s_tpu_torch.models.transformer import init_params

        base = (
            self._cfg_base if self._cfg_base is not None
            else _gpt_config_of(self.size)
        )
        cfg = dataclasses.replace(
            base, kv_page_size=self.page_size, kv_max_pages=self.max_pages
        )
        self._cfg = cfg
        self.device = select_device({}, self._device_arg)

        def init_fn(seed: int):
            model = gpt.GPTLM(base)
            return init_params(model, torch.Generator().manual_seed(seed)).state_dict()

        state = (
            self._params_override if self._params_override is not None
            else _params_from_checkpoint(self.version, init_fn)
        )
        self.module = _load_module(gpt.GPTLM(cfg), state, cfg.dtype, self.device)
        self._pages = gpt.clean_pages(cfg, self.device)
        # run all three serving shapes once (decode [slots], burst prefill
        # [slots, C], trickle prefill [1, C]) against the trash page, so
        # Ready means the libraries are warm; the junk K/V land in page 0,
        # then the pools are zeroed again
        mpp = cfg.pages_per_slot()
        c = self.prefill_chunk
        self.prefill_batch(np.zeros((1, c + 1 + mpp), np.int32))
        self.prefill_batch(np.zeros((self.slots, c + 1 + mpp), np.int32))
        self.decode(np.zeros((self.slots, 2 + mpp), np.int32))
        for k, v in self._pages:
            k.zero_()
            v.zero_()

    @property
    def cfg(self):
        return self._cfg

    @property
    def pages_per_slot(self) -> int:
        return self._cfg.pages_per_slot()

    @property
    def max_len(self) -> int:
        return self._cfg.max_len

    @property
    def vocab_size(self) -> int:
        """Bound on legal token ids (the loop's per-row sanity check)."""
        return self._cfg.vocab_size

    def validate(self, payload: Any):
        """Normalize a payload into ``(tokens int32 [plen], gen_budget,
        sampling)``: a 1-D int token array, or ``{"tokens": ...,
        "gen_tokens": n, "sampling": {...}}``. Raises TypeError on
        malformed payloads and :class:`InvalidRequest` on unservable
        ones."""
        gen = self.gen_tokens
        sampling = None
        if isinstance(payload, dict):
            if "tokens" not in payload:
                raise TypeError("gpt payload dict needs a 'tokens' key")
            try:
                gen = int(payload.get("gen_tokens", gen))
            except (TypeError, ValueError):
                raise TypeError(
                    f"gen_tokens must be an int, got "
                    f"{payload.get('gen_tokens')!r}"
                ) from None
            sampling = _parse_sampling(payload.get("sampling"))
            payload = payload["tokens"]
        arr = np.asarray(payload)
        if arr.ndim != 1 or arr.dtype.kind not in "iu" or arr.shape[0] < 1:
            raise TypeError(
                f"gpt payload must be a non-empty 1-D int token array, got "
                f"{arr.dtype}{arr.shape}"
            )
        if gen < 1:
            raise InvalidRequest(f"gen_tokens must be >= 1, got {gen}")
        if arr.shape[0] + gen > self._cfg.max_len:
            raise InvalidRequest(
                f"prompt of {arr.shape[0]} + {gen} generated tokens "
                f"exceeds max_len={self._cfg.max_len}"
            )
        return arr.astype(np.int32), gen, sampling

    # -- device dispatch (loop-thread only) ---------------------------------

    def _on_device(self, x: Any) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _samp(self, samp: Any):
        if samp is None:
            return None
        if samp is not self._samp_src:
            self._samp_src = samp
            self._samp_dev = (self._on_device(samp[0]), self._on_device(samp[1]))
        return self._samp_dev

    def prefill_batch(self, batch, samp=None):
        """One chunk round for every admitted request (the packed
        ``[rows, C + 1 + pages_per_slot]`` int32 rows of
        ``gpt.prefill_step_packed``); returns the picks ``[rows, C]`` as
        numpy. ``samp`` is the per-row ``(samp_f, samp_i)`` knob pair when
        any admitted row samples.

        Fewer rows than slots (the loop's one-request trickle) run padded
        to the slot width with idle rows, which write only the trash page:
        the card's matmul libraries pick kernels by shape, so a row's
        numbers, and a sampled row's tokens, must not depend on how many
        rows share its dispatch."""
        from tfk8s_tpu_torch.models import gpt

        rows = int(np.shape(batch)[0])
        if rows < self.slots:
            batch = np.concatenate(
                [_host(batch), np.zeros((self.slots - rows, np.shape(batch)[1]), np.int32)])
            if samp is not None:
                idle = self.slots - rows
                samp = (np.concatenate([_host(samp[0]), np.tile(
                            np.array([[0.0, 1.0]], np.float32), (idle, 1))]),
                        np.concatenate([_host(samp[1]), np.zeros((idle, 2), np.int32)]))
        picks, self._pages = gpt.prefill_step_packed(
            self._cfg, self.module, self._pages, self._on_device(batch),
            sampling=self._samp(samp),
        )
        return _host(picks)[:rows]

    def decode(self, state, samp=None):
        """One decode step over the packed state (numpy on a rebuild, else
        the device tensor the last step returned); returns ``(emitted
        tokens as numpy, new_state on the device)``."""
        from tfk8s_tpu_torch.models import gpt

        nxt, new_state, self._pages = gpt.decode_step_packed(
            self._cfg, self.module, self._pages, self._on_device(state),
            sampling=self._samp(samp),
        )
        return _host(nxt), new_state

    def verify(self, state, drafts, samp=None):
        """Speculative-decode scoring: the model's own pick at each of
        ``k + 1`` positions per row, as numpy ``[slots, k + 1]``."""
        from tfk8s_tpu_torch.models import gpt

        picks, self._pages = gpt.verify_step_packed(
            self._cfg, self.module, self._pages, self._on_device(state),
            self._on_device(drafts), sampling=self._samp(samp),
        )
        return _host(picks)

    # -- KV handoff seam (runtime/handoff.py) --------------------------------

    def _rows(self, page_ids) -> torch.Tensor:
        ps = self.page_size
        ids = torch.as_tensor(list(page_ids), dtype=torch.int64)
        rows = (ids[:, None] * ps + torch.arange(ps)[None, :]).reshape(-1)
        return rows.to(self.device)

    def export_kv(self, page_ids):
        """Copy the K/V rows of ``page_ids`` out of the pools as CPU
        tensors, leaf by leaf in the reference's tree order
        (``gpt.page_leaves``): each leaf ``[len(page_ids)*ps, heads,
        head_dim]``, page ``pid`` being rows ``[pid*ps, (pid+1)*ps)``."""
        from tfk8s_tpu_torch.models import gpt

        rows = self._rows(page_ids)
        return [leaf[rows].cpu() for leaf in gpt.page_leaves(self._pages)]

    def import_kv(self, kv_leaves, page_ids) -> None:
        """Land exported K/V rows into this replica's pools at
        ``page_ids`` (same order as :meth:`export_kv` wrote them); leaves
        are tensors (``export_kv``, or a wire buffer decoded by
        ``KVHandoffBuffer.from_bytes`` from either backend)."""
        from tfk8s_tpu_torch.models import gpt

        leaves = gpt.page_leaves(self._pages)
        if len(kv_leaves) != len(leaves):
            raise HandoffError(
                f"buffer carries {len(kv_leaves)} kv leaves, model has "
                f"{len(leaves)} — incompatible model config"
            )
        n_rows = len(page_ids) * self.page_size
        srcs = [torch.as_tensor(src) for src in kv_leaves]
        for i, (leaf, src) in enumerate(zip(leaves, srcs)):
            if (
                tuple(src.shape[1:]) != tuple(leaf.shape[1:])
                or src.shape[0] != n_rows
            ):
                raise HandoffError(
                    f"kv leaf {i} is {tuple(src.shape)}, pool expects "
                    f"[{n_rows}, {', '.join(map(str, leaf.shape[1:]))}]"
                )
        rows = self._rows(page_ids)
        for leaf, src in zip(leaves, srcs):
            leaf.index_copy_(0, rows, src.to(self.device, leaf.dtype))




@dataclass(eq=False)  # identity semantics: deque.remove / slots.index
class _GenRequest:
    tokens: Any           # np.int32 [plen]
    gen_budget: int
    enqueue_t: float
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    dequeue_t: float = 0.0       # admission into a slot
    first_token_t: float = 0.0   # prefill produced the first output token
    out: List[int] = field(default_factory=list)
    # request-scoped observability (empty traceparent = untraced; the
    # timeline below is only collected for traced requests)
    traceparent: str = ""
    tenant: str = ""
    priority: int = 0
    wall_start: float = 0.0      # time.time() at submit, anchors the
    # perf_counter timeline onto the wall clock spans use
    cached_pages: int = 0        # prefix-cache pages reused at admission
    prefill_chunks: int = 0      # chunk rounds this request rode
    token_times: List[float] = field(default_factory=list)
    # disaggregated serving (runtime/handoff.py): a prefill-pool request
    # stops after its first output token and exports the warm KV
    # (prefill_only + decode_budget -> exported buffer rides the
    # result); a decode-pool request arrives WITH a buffer (handoff) and
    # skips prefill entirely
    prefill_only: bool = False
    decode_budget: int = 0
    handoff: Optional[KVHandoffBuffer] = None
    exported: Optional[KVHandoffBuffer] = None
    # per-request sampling knobs (temperature, top_k, top_p, seed) — None
    # means greedy, the bit-identical argmax path. The seed + the
    # absolute-position PRNG fold is what makes a sampled stream survive
    # a preempt/spill/restore cycle unchanged.
    sampling: Optional[_SamplingTuple] = None
    # scheduler accounting: how many times this request was preempted,
    # and the ORIGINAL prompt length (captured at the first spill —
    # spills absorb emitted tokens into ``tokens``, so the resident
    # stream must be rebuilt from the immutable prompt every time)
    preempt_count: int = 0
    prompt_len: int = 0
    # KV economy (runtime/kvtier): the gateway's cache-directory hint —
    # a replica key believed to hold this prompt's prefix warm. Consumed
    # (at most once) by the admission-time peer fetch; empty = no hint.
    kv_peer: str = ""

    def wall(self, t: float) -> float:
        """Map a perf_counter stamp onto the wall clock."""
        return self.wall_start + (t - self.enqueue_t)


@dataclass(eq=False)
class _Slot:
    req: _GenRequest
    lease: Any                   # paging.SlotLease
    idx: int = 0                 # fixed row in the slot bank / step state
    position: int = 0            # absolute write position of the NEXT token
    last_token: int = 0
    # speculative decode: the tokens emitted by this row's LAST round
    # (the draft engine's catch-up chunk; position of chunk[0] is
    # position - len(chunk) + 1). None/empty means the draft has nothing
    # to catch up on and the row sits out speculative rounds.
    spec_chunk: Optional[List[int]] = None


class DecodeLoopExecutor:
    """ORCA-style continuous batching for generative serving: a
    persistent decode loop over a fixed bank of ``slots``, admitting and
    retiring requests at TOKEN granularity against the block-paged KV
    cache (models/gpt.decode_step_packed + runtime/paging.PageAllocator).

    Each iteration the loop (1) retires rows that hit their eos or
    generation budget — their pages free immediately and their slot is
    reusable THIS iteration, (2) admits queued requests into free slots
    while the page pool covers their worst-case budget (FIFO; an
    admission the pool cannot cover stalls, it never corrupts live
    rows), (3) chunk-prefills admissions (page-aligned shared prompt
    prefixes skip straight to cached pages — copy-on-write reuse), and
    (4) runs ONE decode step for every live row. A short request
    admitted behind a long-running one therefore completes mid-batch
    instead of waiting out the batch (the slot-per-batch
    :class:`GptGenerator` behavior this replaces).

    Client surface (submit / drain / queue_depth / report_progress) and
    the requests/queue/execute/total metric families match
    :class:`ModelServer`, so the controller, autoscaler, registry and
    ServeClient work unchanged. New per-token families:
    ``tfk8s_serving_tokens_total``, ``tfk8s_serving_tpot_seconds``
    (per-request mean time per output token),
    ``tfk8s_serving_slot_occupancy`` / ``tfk8s_serving_page_occupancy``
    gauges, and ``tfk8s_serving_prefix_cache_hits_total``.
    """

    def __init__(
        self,
        model: PagedGptDecoder,
        queue_limit: int = 128,
        metrics: Optional[Metrics] = None,
        labels: Optional[Dict[str, str]] = None,
        prefix_cache: bool = True,
        sched_policy: str = "fifo",
        preemption: bool = True,
        aging_s: float = 5.0,
        speculative: Any = None,
        kv_host_bytes: int = 0,
        kv_peer_fetch: bool = False,
        kv_transport: Any = None,
        kv_peer_resolve: Any = None,
    ):
        from tfk8s_tpu_torch.runtime.kvtier import HostKVCache
        from tfk8s_tpu_torch.runtime.paging import PageAllocator
        from tfk8s_tpu_torch.runtime.sched import make_scheduler

        self.model = model
        # vocab bound for the per-row malformed-continuation check; a
        # decoder that declares none (test doubles) skips the upper
        # bound — negative tokens are malformed regardless
        self._vocab_bound = getattr(model, "vocab_size", None)
        self.queue_limit = max(1, int(queue_limit))
        self.metrics = metrics if metrics is not None else get_metrics()
        self.labels = dict(labels or {})
        if model.max_pages - 1 < model.pages_per_slot:
            # a max_len request could NEVER admit — it would sit queued
            # until its submit timeout, forever; refuse loudly at startup
            raise ServeError(
                f"max_pages={model.max_pages} cannot hold one max_len "
                f"request ({model.pages_per_slot} pages of "
                f"{model.page_size} tokens + the trash page)"
            )
        self.allocator = PageAllocator(
            model.max_pages, model.page_size, prefix_cache=prefix_cache
        )
        # KV economy (runtime/kvtier): the device tier's eviction hook
        # always runs — eviction accounting is a bugfix, not a feature
        # flag — but demotion to host only happens with a host budget
        self.allocator.on_evict = self._kv_on_device_evict
        self._kv_host = (
            HostKVCache(
                int(kv_host_bytes), on_evict=self._kv_on_host_evict
            ) if kv_host_bytes and int(kv_host_bytes) > 0 else None
        )
        self._kv_peer_fetch = bool(kv_peer_fetch)
        self._kv_transport = kv_transport
        self._kv_resolve = kv_peer_resolve
        # digest -> (full-page prompt ints, chain length): what the
        # demotion path needs to rebuild a chain's tokens when one of
        # its pages evicts (register_prefix only keeps digests)
        self._kv_chains: Dict[str, Tuple[List[int], int]] = {}
        self.kv_peer_serves = 0
        self._kv_restore_ms: deque = deque(maxlen=256)
        self._cond = threading.Condition()
        # admission order is a pluggable policy (runtime/sched): FIFO is
        # the original behavior bit-identical; "priority" adds the per-class
        # weighted pick + page-spill preemption
        self._q = make_scheduler(sched_policy, aging_s=aging_s)
        self._preemption = bool(preemption) and sched_policy == "priority"
        # speculative decode engine (runtime/sched/speculative) — None
        # runs plain one-token steps; set via serve() env or tests
        self._spec = speculative
        self._known_priorities: set = set()
        self.preempted_total = 0
        self.restored_total = 0
        self._slots: List[Optional[_Slot]] = [None] * model.slots
        self._live = 0
        self._draining = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.served_total = 0
        self.batches_total = 0   # decode iterations
        self.rejected_total = 0
        self.tokens_total = 0
        self._occupancy_sum = 0
        self._qps_last = (time.monotonic(), 0)
        # device-resident packed step state ([slots, 2 + pages_per_slot]
        # int32 — gpt.decode_step_packed): rebuilt from the slot mirrors
        # only when admission, retirement or page-table growth changes a
        # row — steady-state decode feeds the previous step's output
        # state straight back
        self._d_state = None
        self._d_samp = None  # per-row sampling knobs, rebuilt with it
        self._state_dirty = True
        # fault containment: a non-None fault means a GLOBAL
        # failure (device unusable) — the loop is dead, submits refuse
        # with retriable ReplicaUnavailable, report_progress goes
        # non-Ready and the serve controller replaces the pod
        self._fault: Optional[BaseException] = None
        # chaos hooks (tests/chaos.py): poisoned prompt keys whose next
        # decoded token is corrupted to an out-of-vocab id (the hermetic
        # per-row device fault), and an injected submit latency (gray)
        self._chaos_poison: set = set()
        self._chaos_delay_s = 0.0
        for name, help_text in (
            ("tfk8s_serving_rows_quarantined_total",
             "Decode rows retired by per-row fault containment; their "
             "pages are quarantined until verified."),
            ("tfk8s_serving_tokens_total",
             "Generated tokens, counted per decode iteration."),
            ("tfk8s_serving_tpot_seconds",
             "Per-request mean time per output token (decode phase), "
             "by tenant and priority class."),
            ("tfk8s_serving_ttft_seconds",
             "Per-request time to first token (submit to first output), "
             "by tenant and priority class."),
            ("tfk8s_serving_slot_occupancy",
             "Live decode slots / slot capacity of the decode loop."),
            ("tfk8s_serving_page_occupancy",
             "KV pages held (leases + prefix cache) / usable pool."),
            ("tfk8s_serving_prefix_cache_hits_total",
             "Admissions that reused cached prompt-prefix pages."),
            ("tfk8s_serving_prefix_cache_misses_total",
             "Admissions that found no cached prompt prefix and "
             "prefilled from scratch."),
            ("tfk8s_disagg_exports_total",
             "Prefill-pool requests whose warm KV was exported as a "
             "handoff buffer."),
            ("tfk8s_disagg_imports_total",
             "Handoff buffers imported directly into decode slots "
             "(no local prefill)."),
            ("tfk8s_sched_preemptions_total",
             "Rows evicted mid-decode by the priority scheduler, by "
             "reason (page_pressure = spilled and requeued; "
             "spill_failed = export failed, request failed typed)."),
            ("tfk8s_sched_queue_depth",
             "Queued requests per priority class (priority label)."),
            ("tfk8s_sched_spec_accept_ratio",
             "Speculative decode: accepted draft tokens / proposed, "
             "cumulative."),
            ("tfk8s_serving_prefix_cache_evictions_total",
             "Cached prefixes dropped by LRU pressure, by tier "
             "(device = page pool, host = host-RAM KV cache)."),
            ("tfk8s_serving_kv_host_ops_total",
             "Host-tier KV cache traffic: demote (device eviction "
             "parked the chain), restore (a later prompt re-imported "
             "it), restore_failed (corrupt/mismatched entry dropped, "
             "plain prefill ran)."),
            ("tfk8s_serving_kv_peer_fetches_total",
             "Peer-tier prefix pulls, by outcome (ok = warm pages "
             "imported; fallback = any HandoffError, plain prefill "
             "ran)."),
        ):
            self.metrics.describe(name, help_text)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "DecodeLoopExecutor":
        self._thread = threading.Thread(
            target=self._loop, name="decode-loop", daemon=True
        )
        self._thread.start()
        return self

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop accepting, finish every queued AND live request, stop the
        loop. Returns True when everything drained inside ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        while time.monotonic() < deadline:
            with self._cond:
                if not self._q and not self._live:
                    break
            time.sleep(0.005)
        with self._cond:
            drained = not self._q and not self._live
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        return drained

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def live_slots(self) -> int:
        with self._cond:
            return self._live

    @property
    def mean_batch_occupancy(self) -> float:
        """Mean LIVE slots per decode iteration — the continuous-batching
        analogue of requests-per-batch."""
        return (
            self._occupancy_sum / self.batches_total
            if self.batches_total else 0.0
        )

    # -- client side --------------------------------------------------------

    def submit(self, payload: Any, timeout: Optional[float] = 30.0,
               traceparent: Optional[str] = None, tenant: str = "",
               priority: int = 0, kv_peer: str = "") -> Any:
        """Blocking request; raises Overloaded / Draining / InvalidRequest
        / RequestFailed / DeadlineExceeded — the :class:`ModelServer`
        contract. Returns ``{"tokens": [...], "version": ...}`` with the
        generated continuation (ending at eos or the budget). A
        ``traceparent`` makes the request TRACED: the loop collects its
        per-token timeline and retires it as a ``serve.request`` span
        under that parent; tenant/priority label its TTFT/TPOT."""
        try:
            parts = self.model.validate(payload)
        except InvalidRequest:
            self.metrics.inc(
                "tfk8s_serving_requests_total", 1.0,
                {**self.labels, "outcome": "invalid"},
            )
            raise
        # test doubles may still speak the historical 2-tuple contract
        tokens, gen = parts[0], parts[1]
        sampling = parts[2] if len(parts) > 2 else None
        if self._chaos_delay_s:
            time.sleep(self._chaos_delay_s)  # gray replica: alive but slow
        req = _GenRequest(
            tokens=tokens, gen_budget=gen, enqueue_t=time.perf_counter(),
            traceparent=traceparent or "", tenant=tenant,
            priority=int(priority), wall_start=time.time(),
            sampling=sampling, kv_peer=kv_peer or "",
        )
        return self._enqueue_and_wait(req, timeout)

    def submit_prefill(self, payload: Any, timeout: Optional[float] = 30.0,
                       traceparent: Optional[str] = None, tenant: str = "",
                       priority: int = 0, kv_peer: str = "") -> Any:
        """Prefill-pool entry point (disaggregated serving): run chunked
        prefill to completion, pick the FIRST output token, export the
        warm KV, and retire — same typed contract as :meth:`submit`, but
        the result additionally carries ``{"handoff":
        KVHandoffBuffer}`` for the gateway to move to a decode replica.
        The request's real generation budget rides the buffer
        (``decode_budget``); THIS replica only ever holds the row for
        one output token."""
        try:
            parts = self.model.validate(payload)
        except InvalidRequest:
            self.metrics.inc(
                "tfk8s_serving_requests_total", 1.0,
                {**self.labels, "outcome": "invalid"},
            )
            raise
        tokens, gen = parts[0], parts[1]
        sampling = parts[2] if len(parts) > 2 else None
        if self._chaos_delay_s:
            time.sleep(self._chaos_delay_s)
        req = _GenRequest(
            tokens=tokens, gen_budget=1, enqueue_t=time.perf_counter(),
            traceparent=traceparent or "", tenant=tenant,
            priority=int(priority), wall_start=time.time(),
            prefill_only=True, decode_budget=gen, sampling=sampling,
            kv_peer=kv_peer or "",
        )
        return self._enqueue_and_wait(req, timeout)

    def submit_handoff(self, buf: KVHandoffBuffer,
                       timeout: Optional[float] = 30.0,
                       traceparent: Optional[str] = None, tenant: str = "",
                       priority: int = 0, sampling: Any = None) -> Any:
        """Decode-pool entry point (disaggregated serving): admit a row
        whose prefill already happened elsewhere. The buffer's K/V pages
        land in freshly drawn local pages (prefix-cached pages are NOT
        re-copied), the slot seeds at position ``len(tokens)`` with the
        prefill replica's pick, and decoding continues bit-identically
        to a local prefill. Raises :class:`HandoffError` on a buffer
        this replica cannot import (wrong page size / model version /
        integrity failure); otherwise the :meth:`submit` contract.
        ``sampling`` re-applies the request's original sampling knobs on
        the decode side (the buffer carries tokens/KV only) — the same
        seed + absolute-position fold makes the continued stream
        bit-identical to a single-replica sampled run."""
        import numpy as np

        buf.verify()
        if buf.page_size != self.model.page_size:
            raise HandoffError(
                f"buffer page_size={buf.page_size}, replica runs "
                f"{self.model.page_size}"
            )
        if buf.version != self.model.version:
            raise HandoffError(
                f"buffer prefilled under {buf.version!r}, replica serves "
                f"{self.model.version!r} — params differ, refusing a "
                f"non-bit-identical import"
            )
        tokens = np.asarray(buf.tokens, np.int32)
        gen = int(buf.gen_budget)
        if gen < 1:
            raise InvalidRequest(f"gen_budget must be >= 1, got {gen}")
        if len(tokens) + gen > self.model.max_len:
            raise InvalidRequest(
                f"prompt of {len(tokens)} + {gen} generated tokens "
                f"exceeds max_len={self.model.max_len}"
            )
        if self._chaos_delay_s:
            time.sleep(self._chaos_delay_s)
        req = _GenRequest(
            tokens=tokens, gen_budget=gen, enqueue_t=time.perf_counter(),
            traceparent=traceparent or "", tenant=tenant,
            priority=int(priority), wall_start=time.time(),
            handoff=buf,
            sampling=sampling if isinstance(sampling, tuple)
            else _parse_sampling(sampling),
        )
        return self._enqueue_and_wait(req, timeout)

    def _enqueue_and_wait(self, req: _GenRequest,
                          timeout: Optional[float]) -> Any:
        """The shared back half of every submit flavor: bounded-queue
        admission, deadline wait, typed re-raise."""
        with self._cond:
            if self._fault is not None:
                raise ReplicaUnavailable(f"replica failed: {self._fault}")
            if self._draining or self._stopped:
                raise Draining("replica is draining; retry another replica")
            if len(self._q) >= self.queue_limit:
                self.rejected_total += 1
                self.metrics.inc(
                    "tfk8s_serving_requests_total", 1.0,
                    {**self.labels, "outcome": "rejected"},
                )
                raise Overloaded(len(self._q), self.queue_limit)
            self._q.append(req)
            self.metrics.set_gauge(
                "tfk8s_serving_queue_depth", float(len(self._q)), self.labels
            )
            self._sched_gauges_locked()
            self._cond.notify_all()
        if not req.done.wait(timeout):
            timed_out = False
            with self._cond:
                try:
                    self._q.remove(req)
                    timed_out = True
                    self.metrics.inc(
                        "tfk8s_serving_requests_total", 1.0,
                        {**self.labels, "outcome": "timeout"},
                    )
                    self.metrics.set_gauge(
                        "tfk8s_serving_queue_depth", float(len(self._q)),
                        self.labels,
                    )
                    self._sched_gauges_locked()
                except ValueError:
                    pass  # already admitted into a slot; it will finish
            if timed_out and req.traceparent:
                _trace.get_tracer().record_span(
                    "serve.request", req.wall_start, time.time(),
                    traceparent=req.traceparent, status="error",
                    attributes={"outcome": "timeout",
                                "tenant": req.tenant,
                                "priority": req.priority},
                )
            raise DeadlineExceeded(f"request not served within {timeout}s")
        if req.error is not None:
            if isinstance(req.error, ServeError):
                # already typed (RowFault, ReplicaUnavailable, ...):
                # surface AS IS — retriability must survive the hop
                raise req.error
            raise RequestFailed(str(req.error)) from req.error
        return req.result

    # -- the decode loop ----------------------------------------------------

    def _sched_gauges_locked(self) -> None:
        """Per-priority-class queue depth gauges. Classes seen once keep
        reporting (at zero) so a drained class doesn't leave a stale
        last value on the scrape."""
        depths = self._q.class_depths()
        self._known_priorities.update(depths)
        for p in self._known_priorities:
            self.metrics.set_gauge(
                "tfk8s_sched_queue_depth", float(depths.get(p, 0)),
                {**self.labels, "priority": str(p)},
            )

    def _admit_locked(self) -> List[_Slot]:
        """Move queued requests into free slots while the page pool covers
        them. Order is the scheduler's pick — FIFO by default (a stalled
        head blocks later admissions so a stream of small requests can't
        starve a big one), or the aged priority-weighted pick. Under the
        priority policy, a pick that stalls on pages may PREEMPT a
        lower-priority live row: its KV spills to a host-side buffer
        (the handoff serialize path), its request re-enters at the front
        of its class, and admission retries with the freed pages. Caller
        holds the lock."""
        from tfk8s_tpu_torch.runtime.paging import OutOfPages

        admitted: List[_Slot] = []
        while self._live < len(self._slots):
            req = self._q.peek()
            if req is None:
                break
            try:
                if req.handoff is not None:
                    # handoff rows (disagg import OR preemption restore)
                    # draw their prompt pages NOW so the imported K/V
                    # has somewhere to land before step 1; the buffer's
                    # gen_budget is the REMAINING budget after any
                    # already-emitted tokens
                    lease = self.allocator.import_pages(
                        req.tokens, req.handoff.gen_budget
                    )
                else:
                    # KV economy: climb the tiers (host restore, then a
                    # directory-hinted peer fetch) BEFORE admit, so a
                    # warm prefix lands as an ordinary device hit; a
                    # no-op with the tiers off
                    self._kv_promote_locked(req)
                    lease = self.allocator.admit(req.tokens, req.gen_budget)
            except OutOfPages:
                if self._preemption and self._maybe_preempt_locked(req):
                    continue  # pages freed (or victim failed); retry
                break  # admission stalls; retirements will free pages
            self._q.pop(req)
            if lease.cached_pages:
                self.metrics.inc(
                    "tfk8s_serving_prefix_cache_hits_total", 1.0, self.labels
                )
            elif self.allocator.prefix_cache_enabled:
                self.metrics.inc(
                    "tfk8s_serving_prefix_cache_misses_total", 1.0,
                    self.labels,
                )
            req.cached_pages = lease.cached_pages
            req.dequeue_t = time.perf_counter()
            idx = self._slots.index(None)
            slot = _Slot(req=req, lease=lease, idx=idx)
            self._slots[idx] = slot
            self._live += 1
            admitted.append(slot)
        if admitted:
            self.metrics.set_gauge(
                "tfk8s_serving_queue_depth", float(len(self._q)), self.labels
            )
            self._sched_gauges_locked()
        return admitted

    def _maybe_preempt_locked(self, req: _GenRequest) -> bool:
        """A higher-priority admission stalled on pages: evict the
        lowest-priority live row strictly below the stalled request's
        class (youngest first — least sunk cost), spilling its KV to a
        host buffer and requeueing it at the front of its class. Returns
        True when a victim was evicted (the admission loop retries),
        False when no eligible victim exists (the admission stalls, the
        pre-preemption behavior). A spill failure fails the VICTIM typed
        (:class:`Preempted`) with its pages quarantined — still True:
        the slot is free either way. Caller holds the lock (this runs on
        the loop thread inside the admission pass, so no step is in
        flight while rows move)."""
        from tfk8s_tpu_torch.runtime.sched.scheduler import pick_victim

        victim = pick_victim(self._slots, int(req.priority))
        if victim is None:
            return False
        try:
            self._spill_locked(victim)
        except BaseException as e:  # noqa: BLE001 — contain to the victim
            vreq = victim.req
            self.allocator.quarantine(victim.lease)
            self._slots[victim.idx] = None
            self._live -= 1
            self._state_dirty = True
            self.preempted_total += 1
            self.metrics.inc(
                "tfk8s_sched_preemptions_total", 1.0,
                {**self.labels, "reason": "spill_failed"},
            )
            self.metrics.inc(
                "tfk8s_serving_requests_total", 1.0,
                {**self.labels, "outcome": "error"},
            )
            log.warning("preemption spill failed, victim request lost: %s", e)
            vreq.error = Preempted(f"KV spill failed mid-preemption: {e}")
            vreq.done.set()
            return True
        self.preempted_total += 1
        self.metrics.inc(
            "tfk8s_sched_preemptions_total", 1.0,
            {**self.labels, "reason": "page_pressure"},
        )
        return True

    def _spill_locked(self, victim: _Slot) -> None:
        """Serialize a live row's whole KV state into a
        :class:`KVHandoffBuffer` riding its own request, free its pages
        and slot, and requeue it at the front of its priority class. The
        restore is the existing handoff-import admission path, so a
        resumed row continues BIT-IDENTICAL to an unpreempted run: the
        resident tokens (prompt + all-but-last emitted) become the
        buffer's prompt, the last emitted token seeds the decode, and
        the buffer's gen_budget is the remaining budget. The resident
        stream is rebuilt from the ORIGINAL prompt every time —
        ``req.tokens`` absorbs emitted tokens on restore, so a second
        spill concatenating ``req.tokens + out[:-1]`` would duplicate
        them (wrong positions, digest chain, and KV extent)."""
        req = victim.req
        if req.preempt_count == 0:
            # req.tokens is still the pristine prompt only BEFORE the
            # first spill rewrites it below
            req.prompt_len = len(req.tokens)
        resident = [int(t) for t in req.tokens[:req.prompt_len]] + [
            int(t) for t in req.out[:-1]
        ]
        last = int(req.out[-1])
        page_ids, digests = self.allocator.export_pages(victim.lease, resident)
        buf = KVHandoffBuffer(
            version=self.model.version, page_size=self.model.page_size,
            tokens=resident, last_token=last,
            # remaining budget: len(req.out) already emitted, and the
            # buffer's last_token re-enters req.out on restore
            gen_budget=req.gen_budget - len(req.out) + 1,
            digests=digests,
            kv=self.model.export_kv(page_ids),
        )
        import numpy as np

        req.out.pop()  # re-enters as buf.last_token on restore
        req.handoff = buf
        req.tokens = np.asarray(resident, np.int32)
        req.preempt_count += 1
        self.allocator.release(victim.lease)
        self._slots[victim.idx] = None
        self._live -= 1
        self._state_dirty = True
        self._q.requeue_front(req)
        self._sched_gauges_locked()

    # -- KV economy (runtime/kvtier) ----------------------------------------

    def _kv_on_device_evict(self, key: str, pid: int) -> None:
        """``PageAllocator.on_evict``: the device tier is dropping an
        idle cached page. Always accounts the eviction (such drops
        used to be invisible); with a host budget,
        demotes the longest still-resident chain through the evicting
        page before it disappears. Runs inside ``_evict_idle`` under the
        executor lock — reads the allocator, never mutates it."""
        self.metrics.inc(
            "tfk8s_serving_prefix_cache_evictions_total", 1.0,
            {**self.labels, "tier": "device"},
        )
        if self._kv_host is None:
            return
        info = self._kv_chains.get(key)
        if info is None:
            return
        from tfk8s_tpu_torch.runtime.paging import prefix_digest_chain

        toks, m = info
        ps = self.model.page_size
        digests = prefix_digest_chain(toks, ps, m)
        pages = self.allocator.cached_chain(digests)
        r = len(pages)
        if r == 0 or self._kv_host.has(digests[r - 1]):
            # the chain's head already evicted (a later page of an
            # already-demoted chain), or the host holds it — either way
            # there is nothing new to park
            return
        try:
            wire = KVHandoffBuffer.prefix(
                version=self.model.version, page_size=ps,
                tokens=toks[:r * ps], digests=digests[:r],
                kv=self.model.export_kv(pages),
            ).to_bytes()
        except HandoffError as e:
            log.warning("kv host demotion failed, chain dropped: %s", e)
            return
        if self._kv_host.put(digests[r - 1], wire, akey=digests[0]):
            self.metrics.inc(
                "tfk8s_serving_kv_host_ops_total", 1.0,
                {**self.labels, "op": "demote"},
            )

    def _kv_on_host_evict(self, key: str, nbytes: int) -> None:
        """Host-tier LRU overflow: the byte budget pushed a chain out of
        its last tier. Same eviction counter, ``tier="host"``."""
        self.metrics.inc(
            "tfk8s_serving_prefix_cache_evictions_total", 1.0,
            {**self.labels, "tier": "host"},
        )

    def _kv_note_chain(self, tokens: Any) -> None:
        """Remember the tokens behind a registered prefix chain so the
        demotion path can rebuild (and re-hash) the chain when one of
        its pages evicts — ``register_prefix`` itself only keeps
        digests. Bounded: entries for chains no tier still holds are
        pruned once the map outgrows the pool."""
        if self._kv_host is None:
            return
        from tfk8s_tpu_torch.runtime.paging import prefix_digest_chain

        ps = self.model.page_size
        m = max(len(tokens) - 1, 0) // ps  # register_prefix's k_max
        if m == 0:
            return
        toks = [int(t) for t in tokens[:m * ps]]
        for d in prefix_digest_chain(toks, ps, m):
            prev = self._kv_chains.get(d)
            if prev is None or prev[1] < m:
                self._kv_chains[d] = (toks, m)
        if len(self._kv_chains) > 16 * self.allocator.num_pages:
            held = set(self.allocator.cached_keys())
            self._kv_chains = {
                d: v for d, v in self._kv_chains.items()
                if d in held or self._kv_host.has(d)
            }

    def _kv_promote_locked(self, req: _GenRequest) -> None:
        """Admission-time tier climb: before a request admits, pull its
        prefix UP the tiers — host restore first (local, cheap), then a
        directory-hinted peer fetch — so :meth:`PageAllocator.admit`
        sees a plain device hit. Every failure shape degrades to plain
        prefill; this method never raises. Caller holds the lock (loop
        thread, admission pass — no step in flight)."""
        want_peer = bool(self._kv_peer_fetch and req.kv_peer)
        if self._kv_host is None and not want_peer:
            return
        from tfk8s_tpu_torch.runtime.paging import prefix_digest_chain

        peer_hint, req.kv_peer = req.kv_peer, ""  # one attempt, ever
        tokens = req.tokens
        ps = self.model.page_size
        k_max = max(len(tokens) - 1, 0) // ps
        if k_max == 0:
            return
        digests = prefix_digest_chain(tokens, ps, k_max)
        d = len(self.allocator.cached_chain(digests))
        if d >= k_max:
            return  # full device hit already — nothing to climb for
        if self._kv_host is not None:
            for j in range(k_max, d, -1):
                t0 = time.perf_counter()
                try:
                    # get() raises on a checksum mismatch (host-RAM
                    # corruption) — same fallback as a failed adopt
                    wire = self._kv_host.get(digests[j - 1])
                    if wire is None:
                        continue
                    self._kv_adopt_locked(
                        KVHandoffBuffer.from_bytes(wire), digests, d, j
                    )
                except HandoffError as e:
                    # corrupt or unlandable entry: drop it (never offer
                    # it twice) and fall through to peer/plain prefill
                    self._kv_host.discard(digests[j - 1])
                    self.metrics.inc(
                        "tfk8s_serving_kv_host_ops_total", 1.0,
                        {**self.labels, "op": "restore_failed"},
                    )
                    log.warning("kv host restore failed, prefilling: %s", e)
                    break
                self._kv_host.restores += 1
                self._kv_restore_ms.append(
                    (time.perf_counter() - t0) * 1000.0
                )
                self.metrics.inc(
                    "tfk8s_serving_kv_host_ops_total", 1.0,
                    {**self.labels, "op": "restore"},
                )
                self._kv_note_chain(tokens)
                return
        if want_peer:
            from tfk8s_tpu_torch.runtime import kvtier

            try:
                buf = kvtier.fetch_prefix(
                    self._kv_resolve or lookup_replica, peer_hint,
                    tokens, transport=self._kv_transport,
                )
                j = min(len(buf.tokens) // ps, k_max)
                if j <= d:
                    raise HandoffError(
                        "peer prefix no longer than the local one"
                    )
                self._kv_adopt_locked(buf, digests, d, j)
            except HandoffError as e:
                self.metrics.inc(
                    "tfk8s_serving_kv_peer_fetches_total", 1.0,
                    {**self.labels, "outcome": "fallback"},
                )
                log.info("kv peer fetch from %s fell back to prefill: %s",
                         peer_hint, e)
            else:
                self.metrics.inc(
                    "tfk8s_serving_kv_peer_fetches_total", 1.0,
                    {**self.labels, "outcome": "ok"},
                )
                self._kv_note_chain(tokens)

    def _kv_adopt_locked(self, buf: KVHandoffBuffer, digests: List[str],
                         start: int, upto: int) -> None:
        """Warm-insert a verified prefix buffer into the idle device
        cache: draw pages for chain positions ``start..upto-1``, scatter
        the buffer's K/V rows into them, publish them under their
        digests — the admission that follows sees a plain device hit
        (same pages, same bytes: bit-identity by construction). Raises
        :class:`HandoffError` when the buffer cannot land here."""
        ps = self.model.page_size
        if buf.page_size != ps:
            raise HandoffError(
                f"buffer page_size={buf.page_size}, replica runs {ps}"
            )
        if buf.version != self.model.version:
            raise HandoffError(
                f"buffer from {buf.version!r}, replica serves "
                f"{self.model.version!r} — params differ"
            )
        if len(buf.tokens) < upto * ps:
            raise HandoffError(
                f"buffer covers {len(buf.tokens)} token(s), chain needs "
                f"{upto * ps}"
            )
        ticket = self.allocator.restore_begin(digests[:upto], start)
        if ticket is None:
            raise HandoffError("live leases own the pool — cannot restore")
        try:
            self.model.import_kv(
                [leaf[start * ps:upto * ps] for leaf in buf.kv],
                ticket.pages,
            )
        except BaseException as e:  # noqa: BLE001 — roll back, degrade
            self.allocator.restore_abort(ticket)
            if isinstance(e, HandoffError):
                raise
            raise HandoffError(f"restore scatter failed: {e}") from e
        self.allocator.restore_commit(ticket)

    def export_prefix(self, tokens: Any) -> Optional[KVHandoffBuffer]:
        """Peer-tier export: the longest warm prefix of ``tokens`` this
        replica holds, as a verified prefix buffer — device chain first
        (gathered straight from the pool), host tier second (the parked
        wire bytes deserialize back). ``None`` when neither tier has
        it. Called by PEER replicas through
        :func:`kvtier.fetch_prefix`; the gather is
        read-only, so a foreign-thread export never perturbs the loop."""
        from tfk8s_tpu_torch.runtime.paging import prefix_digest_chain

        toks = [int(t) for t in tokens]
        ps = self.model.page_size
        k_max = max(len(toks) - 1, 0) // ps
        if k_max == 0:
            return None
        digests = prefix_digest_chain(toks, ps, k_max)
        # BOUNDED acquire, not ``with``: the caller is another replica's
        # admission path holding ITS loop lock — two replicas hinted at
        # each other must degrade to a fallback prefill, not deadlock
        if not self._cond.acquire(timeout=1.0):
            return None
        try:
            if self._fault is not None or self._stopped:
                return None
            pages = self.allocator.cached_chain(digests)
            if pages:
                r = len(pages)
                try:
                    buf = KVHandoffBuffer.prefix(
                        version=self.model.version, page_size=ps,
                        tokens=toks[:r * ps], digests=digests[:r],
                        kv=self.model.export_kv(pages),
                    )
                except HandoffError:
                    return None
                self.kv_peer_serves += 1
                return buf
            if self._kv_host is not None:
                for j in range(k_max, 0, -1):
                    try:
                        wire = self._kv_host.get(digests[j - 1])
                        if wire is None:
                            continue
                        buf = KVHandoffBuffer.from_bytes(wire)
                    except HandoffError:
                        self._kv_host.discard(digests[j - 1])
                        return None
                    self.kv_peer_serves += 1
                    return buf
        finally:
            self._cond.release()
        return None

    def kv_digest_report(self, limit: int = 512) -> Dict[str, Any]:
        """The cache directory's per-replica digest summary (periodic
        gateway poll — the /debug/routes hit/miss plumbing generalized):
        device-resident cache keys (most-recent tail) plus the affinity
        keys of host-tier entries, with occupancy and hit/miss/eviction
        counts riding along for /debug/routes."""
        with self._cond:
            digests = self.allocator.cached_keys(limit=limit)
            host = None
            if self._kv_host is not None:
                digests.extend(self._kv_host.akeys())
                host = self._kv_host.stats()
            return {
                "digests": digests,
                "host": host,
                "prefix_cache": {
                    "hits": self.allocator.prefix_hits,
                    "misses": self.allocator.prefix_misses,
                    "evictions": self.allocator.evictions,
                },
            }

    def _loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    if self._stopped and not self._q and not self._live:
                        return
                    admitted = self._admit_locked()
                    if admitted or self._live:
                        break
                    self._cond.wait(0.5)
            try:
                if admitted:
                    self._prefill_admitted(admitted)
                if self._live:
                    self._decode_once()
            except BaseException as e:  # noqa: BLE001 — a GLOBAL fault:
                # per-row faults were already contained inside the step
                # (_retire_failed); anything that escapes means the
                # device itself is unusable — fail the world and exit
                # non-Ready so the serve controller replaces the replica
                self._fatal(e)
                return
            self._update_occupancy_gauges()

    def _attached(self, slot: _Slot) -> bool:
        """Whether ``slot`` still holds its row. A chaos hook on another
        thread (``chaos_wire_reset``, ``chaos_crash``) fails every row at
        once through :meth:`_fail_all`, releasing their leases while this
        loop may be mid-prefill or mid-step on them; the loop then drops
        those rows instead of drawing pages for a released lease.
        Caller holds the lock."""
        return self._slots[slot.idx] is slot

    def _pages_for(self, slot: _Slot, upto_tokens: int) -> None:
        """Grow the slot's page table to cover ``upto_tokens`` positions
        (drawn from the lease's admission-time reservation); a row failed
        from another thread meanwhile draws nothing."""
        ps = self.model.page_size
        with self._cond:
            if not self._attached(slot):
                return
            while len(slot.lease.pages) * ps < upto_tokens:
                self.allocator.extend(slot.lease)

    def _prefill_samp(self, pending, rows: int):
        """Per-row sampling knobs for one prefill round — None when every
        pending row is greedy (keeps the original compiled program on
        the pure-greedy path, bit-identical)."""
        import numpy as np

        if not any(e[0].req.sampling for e in pending):
            return None
        samp_f = np.zeros((rows, 2), np.float32)
        samp_f[:, 1] = 1.0  # top_p disabled by default
        samp_i = np.zeros((rows, 2), np.int32)
        for entry in pending:
            slot = entry[0]
            if slot.req.sampling is None:
                continue
            t, k, p, s = slot.req.sampling
            r = 0 if rows == 1 else slot.idx
            samp_f[r] = (t, p)
            samp_i[r] = (k, s)
        return samp_f, samp_i

    def _slot_samp(self):
        """Per-row sampling knobs for the decode/verify dispatch, aligned
        to the slot bank — None when every live row is greedy."""
        import numpy as np

        if not any(
            s is not None and s.req.sampling for s in self._slots
        ):
            return None
        n = len(self._slots)
        samp_f = np.zeros((n, 2), np.float32)
        samp_f[:, 1] = 1.0
        samp_i = np.zeros((n, 2), np.int32)
        for i, slot in enumerate(self._slots):
            if slot is None or slot.req.sampling is None:
                continue
            t, k, p, s = slot.req.sampling
            samp_f[i] = (t, p)
            samp_i[i] = (k, s)
        return samp_f, samp_i

    def _prefill_admitted(self, admitted: List[_Slot]) -> None:
        """Batched chunked prefill: every admitted request's NEXT prompt
        slice rides one ``[slots, C]`` dispatch (gpt.prefill_step_packed)
        — an admission burst costs one dispatch per chunk round, not one
        per request. A cached prefix skips its pages entirely (prefill
        starts at the first uncovered position); a finishing row's first
        output token is its pick at the last real prompt position."""
        import numpy as np

        # Handoff rows (disaggregated serving) skip prefill entirely:
        # their K/V arrives in the buffer and lands by page copy. A
        # buffer that fails import indicts THAT row only — retire it
        # typed with its pages quarantined (they may hold a partial
        # foreign write), siblings untouched.
        imports = [s for s in admitted if s.req.handoff is not None]
        admitted = [s for s in admitted if s.req.handoff is None]
        for slot in imports:
            try:
                with self._cond:
                    if self._attached(slot):
                        self._import_handoff(slot)
            except HandoffError as e:
                self._retire_failed(
                    slot, RowFault(f"handoff import failed: {e}")
                )

        n, mpp = len(self._slots), self.model.pages_per_slot
        chunk_len, ps = self.model.prefill_chunk, self.model.page_size
        # Draw the WHOLE lease up front (admission already reserved it,
        # so this denies nobody anything): the page table then never
        # grows mid-decode and the packed step state stays clean —
        # rebuilds only on admission/retirement.
        for slot in admitted:
            self._pages_for(
                slot, len(slot.req.tokens) + max(slot.req.gen_budget, 1)
            )
        # (slot, next chunk base); cached pages are already covered
        pending = [
            [slot, slot.lease.cached_pages * ps] for slot in admitted
        ]
        while pending:
            with self._cond:
                pending = [e for e in pending if self._attached(e[0])]
            if not pending:
                break
            # a SINGLE pending request (the steady-state trickle: one
            # retirement frees one slot) rides a [1, C] dispatch — a
            # full [slots, C] round would burn slots× the compute for
            # one row; admission bursts batch at full width. Two
            # compiled prefill shapes total.
            rows = 1 if len(pending) == 1 else n
            batch = np.zeros((rows, chunk_len + 1 + mpp), np.int32)
            finishing: List[Tuple[_Slot, int, int]] = []
            for entry in pending:
                slot, base = entry
                slot.req.prefill_chunks += 1
                tokens, plen = slot.req.tokens, len(slot.req.tokens)
                end = min(base + chunk_len, plen)
                self._pages_for(slot, end)
                r = 0 if rows == 1 else slot.idx
                row = batch[r]
                row[: end - base] = tokens[base:end]
                row[chunk_len] = base
                row[chunk_len + 1: chunk_len + 1 + len(slot.lease.pages)] = (
                    slot.lease.pages
                )
                if end >= plen:
                    finishing.append((slot, r, plen - 1 - base))
                entry[1] = end
            samp = self._prefill_samp(pending, rows)
            # keep the 1-arg call when every row is greedy: test doubles
            # (and the draft mirror) override prefill_batch(batch)
            picks = (
                self.model.prefill_batch(batch) if samp is None
                else self.model.prefill_batch(batch, samp)
            )
            if self._spec is not None:
                # mirror the dispatch into the draft pool: same packed
                # rows, same page ids — the draft's prompt K/V must be
                # resident before its first proposal round
                self._spec.prefill_batch(batch)
            now = time.perf_counter()
            for slot, r, pick_idx in finishing:
                with self._cond:
                    if self._attached(slot):
                        self._finish_prefill(slot, int(picks[r, pick_idx]), now)
            pending = [e for e in pending if e[1] < len(e[0].req.tokens)]
        self._state_dirty = True  # admitted rows changed under the state

    def _finish_prefill(self, slot: _Slot, first_tok: int, now: float) -> None:
        """A row's prompt is prefilled: publish its prefix, seed it at the
        prompt's end with its first output token, export its warm K/V when
        it is a prefill-pool request, and retire it when that token ends
        it. Caller holds the lock."""
        req = slot.req
        self.allocator.register_prefix(req.tokens, slot.lease)
        self._kv_note_chain(req.tokens)
        slot.position = len(req.tokens)
        slot.last_token = first_tok
        if self._spec is not None:
            slot.spec_chunk = [first_tok]
        req.out.append(first_tok)
        req.first_token_t = now
        self.tokens_total += 1
        self.metrics.inc("tfk8s_serving_tokens_total", 1.0, self.labels)
        if req.prefill_only:
            # export BEFORE retire frees the lease's pages: the decode
            # pool gets the warm K/V plus the pick
            page_ids, digests = self.allocator.export_pages(slot.lease, req.tokens)
            req.exported = KVHandoffBuffer(
                version=self.model.version, page_size=self.model.page_size,
                tokens=[int(t) for t in req.tokens],
                last_token=first_tok,
                gen_budget=req.decode_budget,
                digests=digests,
                kv=self.model.export_kv(page_ids),
            )
            self.metrics.inc("tfk8s_disagg_exports_total", 1.0, self.labels)
        if len(req.out) >= req.gen_budget or (
            self.model.eos_id is not None and first_tok == self.model.eos_id
        ):
            self._retire(slot)

    def _import_handoff(self, slot: _Slot) -> None:
        """Admit a prefilled-elsewhere row: copy the buffer's K/V into
        the locally drawn prompt pages (prefix-cached pages are already
        resident — only the uncovered tail copies), seed the slot at the
        prompt's end with the prefill replica's pick, and let the next
        decode step continue bit-identically to a local prefill."""
        req = slot.req
        buf = req.handoff
        ps = self.model.page_size
        plen = len(req.tokens)
        # whole lease up front, like the prefill path: the page table
        # never grows mid-decode. The BUFFER's gen_budget bounds the draw
        # — for a preemption restore it is the REMAINING budget, which is
        # exactly what import_pages reserved.
        self._pages_for(slot, plen + max(buf.gen_budget, 1))
        n_prompt = -(-plen // ps)
        dst = slot.lease.pages[slot.lease.cached_pages:n_prompt]
        if dst:
            row0 = slot.lease.cached_pages * ps
            self.model.import_kv(
                [leaf[row0:n_prompt * ps] for leaf in buf.kv], dst
            )
        self.allocator.register_prefix(req.tokens, slot.lease)
        self._kv_note_chain(req.tokens)
        slot.position = plen
        slot.last_token = buf.last_token
        if self._spec is not None:
            # the draft never saw this KV (it arrived as a buffer):
            # rebuild its prompt KV from the tokens, then let the normal
            # catch-up chunk handle the seeded last token
            self._spec.prefill_tokens(
                [int(t) for t in req.tokens], list(slot.lease.pages)
            )
            slot.spec_chunk = [int(buf.last_token)]
        req.out.append(buf.last_token)
        if req.preempt_count:
            # a preemption restore on THIS replica: the row already
            # emitted output here, so its original first_token_t stands
            # (TTFT/TPOT stay anchored to the real first token) and the
            # import counts as a scheduler restore, not a disagg handoff
            self.restored_total += 1
            self.metrics.inc(
                "tfk8s_sched_restores_total", 1.0, self.labels
            )
        else:
            # the first token was generated (and counted in the token
            # metrics) on the PREFILL replica; importing it emits nothing
            req.first_token_t = time.perf_counter()
            self.metrics.inc("tfk8s_disagg_imports_total", 1.0, self.labels)
        if len(req.out) >= req.gen_budget or (
            self.model.eos_id is not None
            and buf.last_token == self.model.eos_id
        ):
            self._retire(slot)

    def _rebuild_state(self) -> None:
        """Re-materialize the packed step state from the slot mirrors —
        only after admission/retirement/page growth; steady-state steps
        feed the previous output state straight back. Kept as NUMPY: the
        decoder moves it to the device in one transfer."""
        import numpy as np

        n = len(self._slots)
        state = np.zeros((n, 2 + self.model.pages_per_slot), np.int32)
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue  # zeros: trash page, position 0 — inert by design
            state[i, 0] = slot.last_token
            state[i, 1] = slot.position
            state[i, 2: 2 + len(slot.lease.pages)] = slot.lease.pages
        self._d_state = state
        self._d_samp = self._slot_samp()
        self._state_dirty = False

    def _decode_once(self) -> None:
        if self._spec is not None:
            self._decode_spec_once()
            return
        live = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            before = len(slot.lease.pages)
            self._pages_for(slot, slot.position + 1)
            if len(slot.lease.pages) != before:
                self._state_dirty = True  # page-table row grew
            live.append(i)
        if self._state_dirty:
            self._rebuild_state()
        # keep the 1-arg call when every row is greedy: test doubles
        # override decode(state) with the original arity
        nxt_dev, state_dev = (
            self.model.decode(self._d_state) if self._d_samp is None
            else self.model.decode(self._d_state, self._d_samp)
        )
        import numpy as np

        nxt = np.asarray(nxt_dev)  # host numpy: the decoder synced once
        self._d_state = state_dev
        self.batches_total += 1
        self._occupancy_sum += len(live)
        self.metrics.inc("tfk8s_serving_batches_total", 1.0, self.labels)
        self.metrics.set_gauge(
            "tfk8s_serving_batch_occupancy", self.mean_batch_occupancy,
            self.labels,
        )
        step_t = time.perf_counter()  # one stamp per step, shared by rows
        emitted = 0
        for i in live:
            slot = self._slots[i]
            if slot is None:
                continue  # a chaos crash raced the step and cleared it
            tok = int(nxt[i])
            if self._chaos_poison:
                tok = self._apply_chaos_poison(slot, tok)
            if tok < 0 or (
                self._vocab_bound is not None and tok >= self._vocab_bound
            ):
                # crash containment: a malformed continuation indicts
                # THIS row's state only — retire it typed, quarantine
                # its pages, keep every sibling row decoding
                self._retire_failed(slot, RowFault(
                    f"row {slot.idx} emitted malformed token {tok} "
                    f"(vocab {self._vocab_bound}) at position "
                    f"{slot.position}; row retired, pages quarantined"
                ))
                continue
            emitted += 1
            slot.position += 1
            slot.last_token = tok
            slot.req.out.append(tok)
            if slot.req.traceparent:
                slot.req.token_times.append(step_t)
            if len(slot.req.out) >= slot.req.gen_budget or (
                self.model.eos_id is not None and tok == self.model.eos_id
            ):
                self._retire(slot)
        self.tokens_total += emitted
        if emitted:
            self.metrics.inc(
                "tfk8s_serving_tokens_total", float(emitted), self.labels
            )

    def _decode_spec_once(self) -> None:
        """One SPECULATIVE iteration: the draft proposes ``k`` tokens per
        live row (catch-up chunk + greedy draft steps, all in the draft's
        own page pool), the target verifies every proposal in ONE packed
        chunk dispatch, and each row emits the longest agreeing prefix
        plus the target's correction token — ``1..k+1`` target-identical
        tokens per iteration instead of exactly one.

        Rows within ``k`` positions of the page-table extent
        (``pages_per_slot * page_size``) sit the round out and take a
        plain single step instead: the verify chunk would otherwise
        scatter K/V past the table and XLA's clamped indexing would
        overwrite the row's own last page (the Pallas-seam accounting —
        see models/transformer.py). Those rows are retiring within ``k``
        tokens anyway."""
        import numpy as np

        k = self._spec.k
        limit = self.model.pages_per_slot * self.model.page_size
        if self._state_dirty:
            self._rebuild_state()
        state = _host(self._d_state)
        spec_rows, tail_rows = [], []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.spec_chunk and slot.position + k < limit:
                spec_rows.append(i)
            else:
                tail_rows.append(i)
        self.batches_total += 1
        self._occupancy_sum += len(spec_rows) + len(tail_rows)
        self.metrics.inc("tfk8s_serving_batches_total", 1.0, self.labels)
        self.metrics.set_gauge(
            "tfk8s_serving_batch_occupancy", self.mean_batch_occupancy,
            self.labels,
        )
        emitted_n = 0
        if spec_rows:
            spec_set = set(spec_rows)
            sslots = [
                s if i in spec_set else None
                for i, s in enumerate(self._slots)
            ]
            drafts = self._spec.propose(sslots)
            vstate = state.copy()
            for i in tail_rows:
                vstate[i] = 0  # inert: junk writes land in the trash page
            picks = self.model.verify(vstate, drafts, self._d_samp)
            step_t = time.perf_counter()
            for i in spec_rows:
                emitted_n += self._accept_spec_row(
                    i, drafts[i], picks[i], step_t
                )
            self.metrics.set_gauge(
                "tfk8s_sched_spec_accept_ratio", self._spec.accept_ratio,
                self.labels,
            )
        if tail_rows:
            tstate = state.copy()
            for i in spec_rows:
                tstate[i] = 0
            nxt = np.asarray(
                (self.model.decode(tstate) if self._d_samp is None
                 else self.model.decode(tstate, self._d_samp))[0]
            )
            step_t = time.perf_counter()
            for i in tail_rows:
                slot = self._slots[i]
                if slot is None:
                    continue
                emitted_n += self._accept_spec_row(
                    i, np.zeros(0, np.int32), nxt[i:i + 1], step_t
                )
        # positions advanced by a per-row amount: the packed state must
        # re-materialize before the next iteration either way
        self._state_dirty = True
        self.tokens_total += emitted_n
        if emitted_n:
            self.metrics.inc(
                "tfk8s_serving_tokens_total", float(emitted_n), self.labels
            )

    def _accept_spec_row(self, i: int, drafts, picks, step_t: float) -> int:
        """Accept-prefix for one row: longest ``drafts[j] == picks[j]``
        prefix, then the target's own correction token — truncated to
        the remaining budget and (inclusively) to eos. Returns how many
        tokens the row emitted. Empty ``drafts`` (a tail row's plain
        step) degenerates to emitting ``picks[0]``."""
        slot = self._slots[i]
        if slot is None:
            return 0  # a chaos crash raced the step and cleared it
        req = slot.req
        a = 0
        while a < len(drafts) and int(drafts[a]) == int(picks[a]):
            a += 1
        toks = [int(t) for t in drafts[:a]] + [int(picks[a])]
        if len(drafts):
            self._spec.record(proposed=len(drafts), accepted=a)
        remaining = req.gen_budget - len(req.out)
        toks = toks[:remaining]
        if self.model.eos_id is not None and self.model.eos_id in toks:
            toks = toks[: toks.index(self.model.eos_id) + 1]
        if self._chaos_poison and toks:
            # per emitted token, like the plain path's per-step check —
            # an armed key is one-shot, so exactly one token poisons
            toks = [self._apply_chaos_poison(slot, t) for t in toks]
        for tok in toks:
            if tok < 0 or (
                self._vocab_bound is not None and tok >= self._vocab_bound
            ):
                self._retire_failed(slot, RowFault(
                    f"row {slot.idx} emitted malformed token {tok} "
                    f"(vocab {self._vocab_bound}) at position "
                    f"{slot.position}; row retired, pages quarantined"
                ))
                return 0
        slot.position += len(toks)
        slot.last_token = toks[-1]
        slot.spec_chunk = list(toks)
        req.out.extend(toks)
        if req.traceparent:
            req.token_times.extend([step_t] * len(toks))
        if len(req.out) >= req.gen_budget or (
            self.model.eos_id is not None
            and toks[-1] == self.model.eos_id
        ):
            self._retire(slot)
        return len(toks)

    def _retire(self, slot: _Slot) -> None:
        """Complete a finished request and free its pages — the slot is
        reusable on the NEXT admission pass, mid-batch."""
        now = time.perf_counter()
        req = slot.req
        with self._cond:
            if not self._attached(slot):
                return  # failed from another thread meanwhile
            self.allocator.release(slot.lease)
            self._slots[slot.idx] = None
            self._live -= 1
            self.served_total += 1
            self._state_dirty = True  # the freed row must stop stepping
        # exemplars attach OPTIMISTICALLY here (the tail verdict isn't in
        # yet): slow/error traces — the ones behind interesting buckets —
        # are always kept, so a high-bucket exemplar stays resolvable
        trace_id = _trace_id_of(req.traceparent)
        self.metrics.inc(
            "tfk8s_serving_requests_total", 1.0,
            {**self.labels, "outcome": "ok"},
        )
        self.metrics.observe(
            "tfk8s_serving_queue_seconds", req.dequeue_t - req.enqueue_t,
            self.labels,
        )
        self.metrics.observe(
            "tfk8s_serving_execute_seconds", now - req.dequeue_t, self.labels
        )
        self.metrics.observe(
            "tfk8s_serving_request_seconds", now - req.enqueue_t, self.labels,
            exemplar=trace_id,
        )
        class_labels = {
            **self.labels, "tenant": req.tenant,
            "priority": str(req.priority),
        }
        if req.first_token_t:
            self.metrics.observe(
                "tfk8s_serving_ttft_seconds",
                req.first_token_t - req.enqueue_t, class_labels,
                exemplar=trace_id,
            )
        if len(req.out) > 1:
            self.metrics.observe(
                "tfk8s_serving_tpot_seconds",
                (now - req.first_token_t) / (len(req.out) - 1),
                class_labels, exemplar=trace_id,
            )
        if req.traceparent:
            self._emit_request_span(req, now)
        req.result = {
            "tokens": list(req.out), "version": self.model.version,
            # first-token latency rides the reply so callers (and the
            # bench) get exact per-request TTFT without scraping buckets
            "ttft_s": round(req.first_token_t - req.enqueue_t, 6)
            if req.first_token_t else None,
        }
        if req.exported is not None:
            # prefill-pool retirement: the warm KV rides the result to
            # the gateway, which moves it across the pool seam
            req.result["handoff"] = req.exported
        req.done.set()

    def _retire_reason(self, req: _GenRequest) -> str:
        if (
            self.model.eos_id is not None and req.out
            and req.out[-1] == self.model.eos_id
        ):
            return "eos"
        return "budget"

    def _emit_request_span(
        self, req: _GenRequest, end_t: float, error: Optional[str] = None
    ) -> None:
        """The per-request timeline, attached as one ``serve.request``
        span under the caller's traceparent: admission wait, prefix-cache
        reuse, prefill chunking, TTFT, a strided sample of per-token
        TPOTs, and the retirement reason."""
        reason = "error" if error is not None else self._retire_reason(req)
        events: List[Dict[str, Any]] = []
        if req.dequeue_t:
            events.append({
                "name": "admitted", "ts": req.wall(req.dequeue_t),
                "attributes": {
                    "queue_wait_s": req.dequeue_t - req.enqueue_t,
                    "cached_pages": req.cached_pages,
                },
            })
        if req.first_token_t:
            events.append({
                "name": "first_token", "ts": req.wall(req.first_token_t),
                "attributes": {
                    "ttft_s": req.first_token_t - req.enqueue_t,
                    "prefill_chunks": req.prefill_chunks,
                },
            })
        times = req.token_times
        if times:
            stride = max(1, len(times) // MAX_TOKEN_EVENTS)
            prev = req.first_token_t or times[0]
            for i, t in enumerate(times):
                if i % stride == 0 or i == len(times) - 1:
                    events.append({
                        "name": "token", "ts": req.wall(t),
                        "attributes": {"i": i + 1, "tpot_s": t - prev},
                    })
                prev = t
        events.append({
            "name": "retire", "ts": req.wall(end_t),
            "attributes": {"reason": reason, "tokens": len(req.out)},
        })
        _trace.get_tracer().record_span(
            "serve.request", req.wall_start, req.wall(end_t),
            traceparent=req.traceparent,
            status="error" if error is not None else "ok",
            attributes={
                "outcome": reason,
                "tenant": req.tenant,
                "priority": req.priority,
                "prompt_tokens": len(req.tokens),
                "tokens_out": len(req.out),
                "cached_pages": req.cached_pages,
                "prefill_chunks": req.prefill_chunks,
                **({"error": error} if error is not None else {}),
            },
            events=events,
        )

    def _retire_failed(self, slot: _Slot, exc: ServeError) -> None:
        """Crash containment: retire ONE faulted row without failing the
        world. Its request fails typed (:class:`RowFault`, a
        RequestFailed), its pages are QUARANTINED — never returned to
        the free list (or the prefix cache) until explicitly verified,
        so a poisoned page can't carry corrupt K/V into a future
        admission — and every sibling row keeps decoding (each row's
        paged attention reads only its own page table, so isolation is
        exact; test-pinned bit-identical siblings)."""
        now = time.perf_counter()
        req = slot.req
        with self._cond:
            if not self._attached(slot):
                return  # failed from another thread meanwhile
            held = self.allocator.quarantine(slot.lease)
            self._slots[slot.idx] = None
            self._live -= 1
            self._state_dirty = True  # the faulted row must stop stepping
        self.metrics.inc(
            "tfk8s_serving_rows_quarantined_total", 1.0, self.labels
        )
        self.metrics.inc(
            "tfk8s_serving_requests_total", 1.0,
            {**self.labels, "outcome": "error"},
        )
        log.warning("decode row fault (%d page(s) quarantined): %s", held, exc)
        if req.traceparent:
            self._emit_request_span(req, now, error=str(exc))
        req.error = exc
        req.done.set()

    def _fail_all(self, e: BaseException) -> None:
        """A device-step failure poisons every in-flight request (the
        ModelServer batch-failure contract, extended to live slots)."""
        with self._cond:
            victims = [s for s in self._slots if s is not None]
            for slot in victims:
                self.allocator.release(slot.lease)
            self._slots = [None] * len(self._slots)
            self._live = 0
            self._state_dirty = True
        if victims:
            self.metrics.inc(
                "tfk8s_serving_requests_total", float(len(victims)),
                {**self.labels, "outcome": "error"},
            )
            log.warning("decode loop failed %d request(s): %s", len(victims), e)
        now = time.perf_counter()
        for slot in victims:
            slot.req.error = e
            if slot.req.traceparent:
                self._emit_request_span(slot.req, now, error=str(e))
            slot.req.done.set()

    def _fail_queued(self, e: BaseException) -> None:
        """Fail every QUEUED (accepted-but-unstarted) request with ``e``
        — the other half of a whole-replica failure; live slots go
        through :meth:`_fail_all`."""
        with self._cond:
            victims = list(self._q)
            self._q.clear()
            self.metrics.set_gauge(
                "tfk8s_serving_queue_depth", 0.0, self.labels
            )
            self._sched_gauges_locked()
        if victims:
            self.metrics.inc(
                "tfk8s_serving_requests_total", float(len(victims)),
                {**self.labels, "outcome": "error"},
            )
        for req in victims:
            req.error = e
            req.done.set()

    def _fatal(self, e: BaseException) -> None:
        """A genuinely GLOBAL fault (device unusable): mark the replica
        faulted — submits now refuse with retriable
        :class:`ReplicaUnavailable`, ``report_progress`` reports
        non-Ready so the entrypoint exits and the serve controller
        replaces the pod — and fail everything the replica holds with
        the same retriable error (the request rode a dying replica;
        nothing about the request itself is suspect, so the gateway
        re-dispatches it to a survivor)."""
        wrapped = (
            e if isinstance(e, ReplicaUnavailable)
            else ReplicaUnavailable(f"replica failed: {e}")
        )
        if not isinstance(e, ReplicaUnavailable):
            wrapped.__cause__ = e
        with self._cond:
            if self._fault is None:  # the cause; later errors follow from it
                self._fault = e
            self._cond.notify_all()
        log.error("decode loop fatal fault, replica exiting non-Ready: %s", e)
        self._fail_all(wrapped)
        self._fail_queued(wrapped)

    @property
    def fault(self) -> Optional[BaseException]:
        """The global fault that killed the loop, if any (the serve
        entrypoint polls this and exits non-Ready on it)."""
        return self._fault

    # -- chaos hooks (tests/chaos.py; never on the production path) ----------

    def chaos_crash(self, message: str = "chaos: replica host died") -> None:
        """Simulate the replica's HOST dying mid-generation: every held
        request fails retriable-ReplicaUnavailable, new submits refuse
        with the same, and the replica goes non-Ready. The registry
        entry is NOT removed — a dead host can't unregister; discovery
        (gateway health ejection, stale aging) is what stops traffic."""
        self._fatal(ReplicaUnavailable(message))
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def chaos_wire_reset(self, message: str = "chaos: wire reset") -> None:
        """Fail every accepted-but-unanswered request ONCE with
        retriable ReplicaUnavailable — the replica stays healthy and
        keeps serving (a dropped connection, not a dead host)."""
        err = ReplicaUnavailable(message)
        self._fail_all(err)
        self._fail_queued(err)

    def chaos_delay(self, seconds: float) -> None:
        """Gray failure: every subsequent submit stalls ``seconds``
        before enqueueing — alive and correct, but slow (the failure
        mode the gateway's latency-EWMA detector must catch)."""
        self._chaos_delay_s = max(0.0, float(seconds))

    def chaos_poison_row(self, tokens: Any) -> None:
        """Arm a per-row fault: the request whose prompt matches
        ``tokens`` emits a malformed (out-of-vocab) token on its next
        decode step — the hermetic simulation of poisoned pages."""
        self._chaos_poison.add(tuple(int(t) for t in tokens))

    def _apply_chaos_poison(self, slot: _Slot, tok: int) -> int:
        key = tuple(int(t) for t in slot.req.tokens)
        if key in self._chaos_poison:
            self._chaos_poison.discard(key)
            return -1
        return tok

    def _update_occupancy_gauges(self) -> None:
        self.metrics.set_gauge(
            "tfk8s_serving_slot_occupancy",
            self._live / max(len(self._slots), 1), self.labels,
        )
        self.metrics.set_gauge(
            "tfk8s_serving_page_occupancy",
            self.allocator.used_pages / max(self.allocator.num_pages - 1, 1),
            self.labels,
        )

    # -- live introspection (/debug/decode) ---------------------------------

    def debug_state(self) -> Dict[str, Any]:
        """Zpages view of the loop RIGHT NOW: per-slot occupancy (row
        position, page count, progress, owner) and page-pool pressure —
        what ``/debug/decode`` renders per replica."""
        with self._cond:
            slots: List[Optional[Dict[str, Any]]] = []
            for slot in self._slots:
                if slot is None:
                    slots.append(None)
                    continue
                req = slot.req
                slots.append({
                    "position": slot.position,
                    "pages": len(slot.lease.pages),
                    "prompt_tokens": len(req.tokens),
                    "tokens_out": len(req.out),
                    "gen_budget": req.gen_budget,
                    "tenant": req.tenant,
                    "priority": req.priority,
                    "trace_id": _trace_id_of(req.traceparent),
                })
            sched: Dict[str, Any] = {
                "policy": getattr(self._q, "policy", "fifo"),
                "queue_by_priority": {
                    str(p): d for p, d in sorted(self._q.class_depths().items())
                },
                "preemptions": self.preempted_total,
                "restores": self.restored_total,
            }
            if self._spec is not None:
                sched["speculative"] = {
                    "k": self._spec.k,
                    "proposed": self._spec.proposed_total,
                    "accepted": self._spec.accepted_total,
                    "accept_ratio": round(self._spec.accept_ratio, 4),
                }
            return {
                "kind": "decode_loop",
                "queue_depth": len(self._q),
                "live_slots": self._live,
                "slot_capacity": len(self._slots),
                "slots": slots,
                "scheduler": sched,
                "pages_used": self.allocator.used_pages,
                "pages_total": self.allocator.num_pages,
                "served_total": self.served_total,
                "tokens_total": self.tokens_total,
                "prefix_cache": {
                    "hits": self.allocator.prefix_hits,
                    "misses": self.allocator.prefix_misses,
                    "hit_ratio": round(
                        self.allocator.prefix_hits
                        / max(
                            self.allocator.prefix_hits
                            + self.allocator.prefix_misses, 1
                        ), 4,
                    ),
                    # device-tier LRU drops used to be
                    # invisible — occupancy looked fine while hot
                    # prefixes silently churned
                    "evictions_device": self.allocator.evictions,
                },
                # host-tier occupancy beside the hit/miss counters
                # (null when the serve has no KVTierPolicy)
                "kv_host": (
                    {
                        **self._kv_host.stats(),
                        "restore_ms_mean": round(
                            sum(self._kv_restore_ms)
                            / len(self._kv_restore_ms), 3,
                        ) if self._kv_restore_ms else 0.0,
                    } if self._kv_host is not None else None
                ),
                "kv_peer_serves": self.kv_peer_serves,
            }

    # -- load reporting (progress → pod status → autoscaler) ----------------

    def report_progress(self) -> Dict[str, float]:
        now = time.monotonic()
        last_t, last_served = self._qps_last
        dt = now - last_t
        qps = (self.served_total - last_served) / dt if dt > 0 else 0.0
        self._qps_last = (now, self.served_total)
        values = {
            "serving_ready": 0.0 if self._fault is not None else 1.0,
            "serving_queue_depth": float(self.queue_depth),
            "serving_qps": qps,
            "serving_batch_occupancy": self.mean_batch_occupancy,
            "serving_requests": float(self.served_total),
            "serving_tokens": float(self.tokens_total),
            "serving_live_slots": float(self.live_slots),
        }
        _progress.report(**values)
        return values


# ---------------------------------------------------------------------------
# The slot-per-batch executor (TFK8S_SERVE_DECODE_LOOP=0, echo, mlp)
# ---------------------------------------------------------------------------


def make_model(task: str, checkpoint: str, batching_max: int,
               env: Optional[Dict[str, str]] = None) -> ServedModel:
    """Served-model factory by ``spec.task`` (reference ``server.py:2493``);
    the mlp and gpt models run on the card unless ``TFK8S_DEVICE`` in
    ``env`` asks for the CPU."""
    env = env or {}
    if task == "echo":
        return EchoModel(checkpoint, delay_ms=float(env.get("TFK8S_SERVE_ECHO_DELAY_MS", "0")))
    if task == "mlp":
        return MlpClassifier(checkpoint, batching_max,
                             hidden=int(env.get("TFK8S_SERVE_MLP_HIDDEN", "64")),
                             device=select_device(env))
    if task in ("gpt", "t5"):
        # t5 rides the decoder-only generate path, as in the reference
        return GptGenerator(
            checkpoint, batching_max,
            gen_tokens=int(env.get("TFK8S_SERVE_GEN_TOKENS", "16")),
            size=env.get("TFK8S_SERVE_GPT_SIZE", "tiny"),
            device=select_device(env),
        )
    raise ServeError(f"unknown serve task {task!r} (known: echo, mlp, gpt, t5)")


@dataclass
class _Request:
    payload: Any
    bucket: Any
    enqueue_t: float
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    # stamped at dispatch so queue/execute split exactly once per request
    dequeue_t: float = 0.0
    # request-scoped observability (empty traceparent = untraced)
    traceparent: str = ""
    tenant: str = ""
    priority: int = 0
    wall_start: float = 0.0


class ModelServer:
    """Bounded-queue dynamic batcher around one :class:`ServedModel`, a
    copy of the reference's (``server.py:2563``), which its bench baseline
    measures the decode loop against:

    - a batch closes at ``max_batch_size`` or ``batch_timeout_s`` after it
      opened (first request dequeued), whichever comes first;
    - only requests whose bucket matches the batch head ride the batch;
    - a submit past ``queue_limit`` sheds with :class:`Overloaded`; after
      :meth:`drain` began, with :class:`Draining`;
    - the queue/execute/total latency histograms observe every served
      request exactly once (shed requests count only in
      ``tfk8s_serving_requests_total{outcome="rejected"}``).
    """

    def __init__(
        self,
        model: ServedModel,
        max_batch_size: int = 8,
        batch_timeout_s: float = 0.01,
        queue_limit: int = 128,
        metrics: Optional[Metrics] = None,
        labels: Optional[Dict[str, str]] = None,
    ):
        self.model = model
        self.max_batch_size = max(1, int(max_batch_size))
        self.batch_timeout_s = max(0.0, float(batch_timeout_s))
        self.queue_limit = max(self.max_batch_size, int(queue_limit))
        self.metrics = metrics if metrics is not None else get_metrics()
        self.labels = dict(labels or {})
        self._cond = threading.Condition()
        self._q: deque = deque()
        self._draining = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.served_total = 0
        self.batches_total = 0
        self.rejected_total = 0
        self._qps_last = (time.monotonic(), 0)
        self._fault: Optional[BaseException] = None
        self._chaos_delay_s = 0.0
        for name, help_text in (
            ("tfk8s_serving_requests_total",
             "Serving requests by outcome (ok / rejected / error)."),
            ("tfk8s_serving_batches_total", "Batches executed by the server."),
            ("tfk8s_serving_queue_seconds",
             "Per-request time from submit to batch dispatch."),
            ("tfk8s_serving_execute_seconds",
             "Per-request model execution time (its batch's wall time)."),
            ("tfk8s_serving_request_seconds",
             "Per-request total latency, submit to response."),
            ("tfk8s_serving_queue_depth", "Pending requests in the bounded queue."),
            ("tfk8s_serving_batch_occupancy",
             "Mean requests per executed batch since start."),
        ):
            self.metrics.describe(name, help_text)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ModelServer":
        self._thread = threading.Thread(target=self._loop, name="serve-batcher", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop accepting, finish everything queued, stop the batcher.
        Returns True when the queue fully drained inside ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        while time.monotonic() < deadline:
            with self._cond:
                if not self._q:
                    break
            time.sleep(0.005)
        with self._cond:
            drained = not self._q
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        return drained

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def mean_batch_occupancy(self) -> float:
        return self.served_total / self.batches_total if self.batches_total else 0.0

    # -- client side --------------------------------------------------------

    def submit(self, payload: Any, timeout: Optional[float] = 30.0,
               traceparent: Optional[str] = None, tenant: str = "",
               priority: int = 0) -> Any:
        """Blocking request: the model's response for ``payload``, or
        Overloaded / Draining / InvalidRequest / RequestFailed /
        DeadlineExceeded. A ``traceparent`` makes the request traced: its
        served interval lands as a ``serve.request`` span under it."""
        try:
            bucket = self.model.bucket_of(payload)  # TypeError: bad payload
        except InvalidRequest:
            # unservable by contract: a typed outcome with its own label
            self.metrics.inc("tfk8s_serving_requests_total", 1.0,
                             {**self.labels, "outcome": "invalid"})
            raise
        if self._chaos_delay_s:
            time.sleep(self._chaos_delay_s)  # gray replica: alive but slow
        req = _Request(
            payload=payload, bucket=bucket, enqueue_t=time.perf_counter(),
            traceparent=traceparent or "", tenant=tenant,
            priority=int(priority), wall_start=time.time(),
        )
        with self._cond:
            if self._fault is not None:
                raise ReplicaUnavailable(f"replica failed: {self._fault}")
            if self._draining or self._stopped:
                raise Draining("replica is draining; retry another replica")
            if len(self._q) >= self.queue_limit:
                self.rejected_total += 1
                self.metrics.inc("tfk8s_serving_requests_total", 1.0,
                                 {**self.labels, "outcome": "rejected"})
                raise Overloaded(len(self._q), self.queue_limit)
            self._q.append(req)
            self.metrics.set_gauge("tfk8s_serving_queue_depth", float(len(self._q)), self.labels)
            self._cond.notify_all()
        if not req.done.wait(timeout):
            # a request still queued is removed and counted timeout; one
            # already in a dispatched batch completes server-side
            timed_out = False
            with self._cond:
                try:
                    self._q.remove(req)
                    timed_out = True
                    self.metrics.inc("tfk8s_serving_requests_total", 1.0,
                                     {**self.labels, "outcome": "timeout"})
                    self.metrics.set_gauge("tfk8s_serving_queue_depth",
                                           float(len(self._q)), self.labels)
                except ValueError:
                    pass  # already dequeued into a batch
            if timed_out and req.traceparent:
                _trace.get_tracer().record_span(
                    "serve.request", req.wall_start, time.time(),
                    traceparent=req.traceparent, status="error",
                    attributes={"outcome": "timeout", "tenant": req.tenant,
                                "priority": req.priority},
                )
            raise DeadlineExceeded(f"request not served within {timeout}s")
        if req.error is not None:
            if isinstance(req.error, ServeError):
                raise req.error  # typed; retriability survives the hop
            raise RequestFailed(str(req.error)) from req.error
        return req.result

    # -- chaos hooks (tests; never on the production path) -------------------

    @property
    def fault(self) -> Optional[BaseException]:
        return self._fault

    def _fail_queued(self, e: BaseException) -> None:
        with self._cond:
            victims = list(self._q)
            self._q.clear()
            self.metrics.set_gauge("tfk8s_serving_queue_depth", 0.0, self.labels)
            self._cond.notify_all()
        if victims:
            self.metrics.inc("tfk8s_serving_requests_total", float(len(victims)),
                             {**self.labels, "outcome": "error"})
        for req in victims:
            req.error = e
            req.done.set()

    def chaos_crash(self, message: str = "chaos: replica host died") -> None:
        """Host death: queued requests fail ReplicaUnavailable, new submits
        refuse with the same, report_progress goes non-Ready; the registry
        entry stays (a dead host cannot unregister)."""
        err = ReplicaUnavailable(message)
        with self._cond:
            self._fault = err
            self._stopped = True
            self._cond.notify_all()
        self._fail_queued(err)

    def chaos_wire_reset(self, message: str = "chaos: wire reset") -> None:
        """Fail the queued requests once with ReplicaUnavailable; the
        replica keeps serving."""
        self._fail_queued(ReplicaUnavailable(message))

    def chaos_delay(self, seconds: float) -> None:
        """Gray failure: every later submit stalls ``seconds``."""
        self._chaos_delay_s = max(0.0, float(seconds))

    # -- the batcher --------------------------------------------------------

    def _take_matching(self, bucket: Any, want: int) -> List[_Request]:
        """Pop up to ``want`` queued requests of ``bucket`` (FIFO among
        matches; the others keep their positions). Caller holds the lock."""
        taken: List[_Request] = []
        if want <= 0:
            return taken
        kept: deque = deque()
        while self._q:
            r = self._q.popleft()
            if len(taken) < want and r.bucket == bucket:
                taken.append(r)
            else:
                kept.append(r)
        self._q = kept
        return taken

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stopped:
                    self._cond.wait(0.5)
                if self._stopped and not self._q:
                    return
                head = self._q.popleft()
                batch = [head]
                deadline = time.monotonic() + self.batch_timeout_s
                # fill from what is queued, then wait out the rest of the
                # timeout for stragglers: size or time closes the batch
                batch += self._take_matching(head.bucket, self.max_batch_size - len(batch))
                while len(batch) < self.max_batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stopped or self._draining:
                        break
                    self._cond.wait(remaining)
                    batch += self._take_matching(head.bucket, self.max_batch_size - len(batch))
                self.metrics.set_gauge("tfk8s_serving_queue_depth", float(len(self._q)),
                                       self.labels)
            self._execute(batch)

    def _execute(self, batch: List[_Request]) -> None:
        t0 = time.perf_counter()
        for r in batch:
            r.dequeue_t = t0
        try:
            results = self.model.forward([r.payload for r in batch])
            if len(results) != len(batch):  # a model bug, not a request bug
                raise RequestFailed(
                    f"model returned {len(results)} results for a batch of {len(batch)}"
                )
        except BaseException as e:  # noqa: BLE001 — fan the failure out
            t1 = time.perf_counter()
            for r in batch:
                r.error = e
                if r.traceparent:
                    _trace.get_tracer().record_span(
                        "serve.request", r.wall_start, r.wall_start + (t1 - r.enqueue_t),
                        traceparent=r.traceparent, status="error",
                        attributes={"outcome": "error", "error": str(e),
                                    "tenant": r.tenant, "priority": r.priority},
                    )
                r.done.set()
            self.metrics.inc("tfk8s_serving_requests_total", float(len(batch)),
                             {**self.labels, "outcome": "error"})
            log.warning("batch of %d failed: %s", len(batch), e)
            return
        t1 = time.perf_counter()
        self.batches_total += 1
        self.served_total += len(batch)
        self.metrics.inc("tfk8s_serving_batches_total", 1.0, self.labels)
        self.metrics.inc("tfk8s_serving_requests_total", float(len(batch)),
                         {**self.labels, "outcome": "ok"})
        self.metrics.set_gauge("tfk8s_serving_batch_occupancy", self.mean_batch_occupancy,
                               self.labels)
        exec_s = t1 - t0
        for r, res in zip(batch, results):
            # one observation per served request per family, all here
            self.metrics.observe("tfk8s_serving_queue_seconds", r.dequeue_t - r.enqueue_t,
                                 self.labels)
            self.metrics.observe("tfk8s_serving_execute_seconds", exec_s, self.labels)
            self.metrics.observe("tfk8s_serving_request_seconds", t1 - r.enqueue_t,
                                 self.labels, exemplar=_trace_id_of(r.traceparent))
            if r.traceparent:
                _trace.get_tracer().record_span(
                    "serve.request", r.wall_start, r.wall_start + (t1 - r.enqueue_t),
                    traceparent=r.traceparent,
                    attributes={"outcome": "ok", "tenant": r.tenant,
                                "priority": r.priority, "batch_size": len(batch)},
                    events=[{
                        "name": "dispatched",
                        "ts": r.wall_start + (r.dequeue_t - r.enqueue_t),
                        "attributes": {"queue_wait_s": r.dequeue_t - r.enqueue_t,
                                       "execute_s": exec_s},
                    }],
                )
            r.result = res
            r.done.set()

    # -- live introspection (/debug/decode) ---------------------------------

    def debug_state(self) -> Dict[str, Any]:
        """The batcher's zpage view (no slots or pages)."""
        with self._cond:
            return {
                "kind": "batch",
                "queue_depth": len(self._q),
                "served_total": self.served_total,
                "batches_total": self.batches_total,
                "rejected_total": self.rejected_total,
            }

    # -- load reporting (progress -> pod status -> autoscaler) ----------------

    def report_progress(self) -> Dict[str, float]:
        now = time.monotonic()
        last_t, last_served = self._qps_last
        dt = now - last_t
        qps = (self.served_total - last_served) / dt if dt > 0 else 0.0
        self._qps_last = (now, self.served_total)
        values = {
            "serving_ready": 0.0 if self._fault is not None else 1.0,
            "serving_queue_depth": float(self.queue_depth),
            "serving_qps": qps,
            "serving_batch_occupancy": self.mean_batch_occupancy,
            "serving_requests": float(self.served_total),
        }
        _progress.report(**values)
        return values


# ---------------------------------------------------------------------------
# Metrics registry hook (the operator process may wire its registry in;
# standalone use falls back to a private one)
# ---------------------------------------------------------------------------

_metrics_lock = threading.Lock()
_metrics: Optional[Metrics] = None


def set_metrics(metrics: Metrics) -> None:
    global _metrics
    with _metrics_lock:
        _metrics = metrics


def get_metrics() -> Metrics:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            _metrics = Metrics()
        return _metrics


# ---------------------------------------------------------------------------
# Replica registry + entrypoint (the kubelet-facing half)
# ---------------------------------------------------------------------------

_registry_lock = threading.Lock()
# the port's own replica table, where the port's gateway and serve client
# look; under a foreign node agent, ``serve`` registers each replica in the
# agent's table as well, where that agent's gateway looks
_REPLICAS: Dict[str, Any] = {}
# callbacks fired (outside the lock) when a replica unregisters: the
# port's gateway route tables subscribe, so a Draining replica leaves the
# routing set the instant its drain starts, before the kubelet flush
# would publish it (the wire half of the zero-failed-request contract)
_drain_hooks: List[Callable[[str], None]] = []


def register_replica(key: str, server: Any) -> None:
    with _registry_lock:
        _REPLICAS[key] = server


def add_drain_hook(fn: Callable[[str], None]) -> None:
    with _registry_lock:
        _drain_hooks.append(fn)


def remove_drain_hook(fn: Callable[[str], None]) -> None:
    with _registry_lock:
        if fn in _drain_hooks:
            _drain_hooks.remove(fn)


def unregister_replica(key: str) -> None:
    with _registry_lock:
        _REPLICAS.pop(key, None)
        hooks = list(_drain_hooks)
    for fn in hooks:  # outside the lock: hooks may take their own locks
        try:
            fn(key)
        except Exception:  # noqa: BLE001 - a bad subscriber can't block drain
            log.exception("drain hook failed for %s", key)


def lookup_replica(key: str) -> Optional[Any]:
    with _registry_lock:
        return _REPLICAS.get(key)


def replica_keys() -> List[str]:
    with _registry_lock:
        return sorted(_REPLICAS)


def chaos_crash_replica(key: str, message: str = "chaos: replica host died") -> bool:
    """Chaos entry (the reference's ``chaos_crash_replica``): crash the
    replica registered under ``key`` WITHOUT unregistering it, here or in
    the node agent's table. The corpse stays where callers find it until
    the gateway's health machinery ejects it, as a crashed host looks from
    the serving plane; its ``serve()`` then exits with the fault. Returns
    False when ``key`` is not registered."""
    server = lookup_replica(key)
    if server is None:
        return False
    server.chaos_crash(message)
    return True


# How often the serving entrypoint refreshes its progress report (the
# node agent flushes progress into pod status on its own clock).
PROGRESS_PERIOD_S = 0.2


def replica_is_ready(pod) -> bool:
    """THE replica-readiness predicate, shared by the serve controller's
    rollout gating and the routing of ``ServeClient`` and the gateway (one
    definition: the two must never disagree, or the zero-failed-request
    rollout contract breaks): live, RUNNING, and the server reported
    ``serving_ready`` after loading the checkpoint (published into pod
    status by the kubelet flush)."""
    from tfk8s_tpu_torch.api.types import PodPhase

    return (
        pod.metadata.deletion_timestamp is None
        and pod.status.phase == PodPhase.RUNNING
        and pod.status.training.get("serving_ready") == 1.0
    )


def serve(env: Dict[str, str], stop: Optional[threading.Event] = None) -> None:
    """The TPUServe pod entrypoint for the port, with the reference's env
    keys and defaults (``server.py:3032``): load -> register -> Ready ->
    report load until stopped -> drain. ``gpt``/``t5`` run the
    continuous-batching decode loop; ``TFK8S_SERVE_DECODE_LOOP=0`` pins the
    slot-per-batch :class:`ModelServer`, which also serves ``echo`` and
    ``mlp``. Readiness (``serving_ready``) and load go through the node
    agent's progress sink, and a reclaim notice raises the node agent's
    ``PodDrained`` after the drain (``runtime/node_agent``). Under a node
    agent whose serving module is loaded, the replica is registered in
    that table too (``runtime/agent_replica``), so the agent's gateway
    routes to it, and unregistering there fires the gateway's drain
    hooks; the decode loop's KV peer fetch looks peers up in both
    tables."""
    from tfk8s_tpu_torch.runtime.agent_replica import AgentReplica

    task = env.get("TFK8S_SERVE_TASK", "echo")
    checkpoint = env.get("TFK8S_SERVE_CHECKPOINT", "")
    max_batch = int(env.get("TFK8S_SERVE_MAX_BATCH", "8"))
    queue_limit = int(env.get("TFK8S_SERVE_QUEUE_LIMIT", "128"))
    stop = stop if stop is not None else threading.Event()
    ns = env.get("TFK8S_NAMESPACE", "default")
    pod = env.get("TFK8S_POD_NAME", "")
    serve_name = env.get("TFK8S_SERVE_NAME", "")
    phase = env.get("TFK8S_SERVE_PHASE", "")
    labels = {"serve": serve_name, "pod": pod}
    if phase:
        labels["phase"] = phase
    key = f"{ns}/{pod}"
    decode_loop = task in ("gpt", "t5") and env.get("TFK8S_SERVE_DECODE_LOOP", "1") != "0"
    reclaimed = False
    fault: Optional[BaseException] = None
    agent = node_agent.serving_module(stop)

    def resolve_peer(peer_key: str) -> Any:
        """A KV peer by replica key: the port's table, then the agent's
        (whose JAX replicas' buffers carry the same wire bytes)."""
        found = lookup_replica(peer_key)
        if found is None and agent is not None:
            found = agent.lookup_replica(peer_key)
        return found

    with node_agent.attach(stop):
        if decode_loop:
            model = PagedGptDecoder(
                checkpoint,
                slots=max_batch,
                page_size=int(env.get("TFK8S_SERVE_PAGE_SIZE", "16")),
                max_pages=int(env.get("TFK8S_SERVE_MAX_PAGES", "256")),
                gen_tokens=int(env.get("TFK8S_SERVE_GEN_TOKENS", "16")),
                size=env.get("TFK8S_SERVE_GPT_SIZE", "tiny"),
                prefill_chunk=int(env.get("TFK8S_SERVE_PREFILL_CHUNK", "32")),
                eos_id=(
                    int(env["TFK8S_SERVE_EOS_ID"])
                    if env.get("TFK8S_SERVE_EOS_ID") else None
                ),
                device=select_device(env),
            )
            model.load()  # Ready is honest: the weights are resident before it
            speculative = None
            if env.get("TFK8S_SERVE_SPEC_DECODE", "0") != "0":
                from tfk8s_tpu_torch.runtime.sched import SpeculativeEngine

                speculative = SpeculativeEngine.build(
                    model,
                    k=int(env.get("TFK8S_SERVE_SPEC_TOKENS", "4")),
                    size=env.get("TFK8S_SERVE_SPEC_DRAFT", "tiny"),
                )
            server = DecodeLoopExecutor(
                model,
                queue_limit=queue_limit,
                metrics=get_metrics(),
                labels=labels,
                prefix_cache=env.get("TFK8S_SERVE_PREFIX_CACHE", "1") != "0",
                sched_policy=env.get("TFK8S_SERVE_SCHED_POLICY", "fifo"),
                preemption=env.get("TFK8S_SERVE_PREEMPTION", "1") != "0",
                aging_s=float(env.get("TFK8S_SERVE_AGING_S", "5.0")),
                speculative=speculative,
                kv_host_bytes=int(env.get("TFK8S_KV_HOST_BYTES", "0")),
                kv_peer_fetch=env.get("TFK8S_KV_PEER_FETCH", "0") != "0",
                kv_peer_resolve=resolve_peer,
            ).start()
        else:
            model = make_model(task, checkpoint, max_batch, env)
            model.load()  # Ready is honest: the weights are resident before it
            server = ModelServer(
                model,
                max_batch_size=max_batch,
                batch_timeout_s=float(env.get("TFK8S_SERVE_BATCH_TIMEOUT_MS", "10")) / 1000.0,
                queue_limit=queue_limit,
                metrics=get_metrics(),
                labels=labels,
            ).start()
        register_replica(key, server)
        if agent is not None:
            agent.register_replica(key, AgentReplica(server, agent))
        server.report_progress()
        log.info("%s: serving %s ready on %s; version=%s", key, task,
                 getattr(model, "device", None), model.version)
        try:
            while not stop.wait(PROGRESS_PERIOD_S):
                # a GLOBAL fault (device unusable) exits non-Ready without
                # the drain protocol: the registry keeps the corpse, and
                # the raised error fails the pod
                fault = getattr(server, "fault", None)
                if fault is not None:
                    log.error("%s: replica fault, exiting non-Ready: %s",
                              key, fault)
                    break
                # a reclaim notice: unregister, drain what was accepted,
                # exit Drained so the controller replaces the pod
                if getattr(stop, "drain_requested", False):
                    reclaimed = True
                    log.info("%s: reclaim notice; draining replica", key)
                    break
                server.report_progress()
        finally:
            if fault is not None:
                server.report_progress()  # publish serving_ready 0.0
            else:
                # unregister first so callers stop picking this replica
                # (the agent's table fires the gateway's drain hooks), then
                # finish what it already holds
                unregister_replica(key)
                if agent is not None:
                    agent.unregister_replica(key)
                drained = server.drain(
                    timeout=float(env.get("TFK8S_SERVE_DRAIN_TIMEOUT_S", "30"))
                )
                log.info("%s: drained=%s after %d requests in %d batches",
                         key, drained, server.served_total, server.batches_total)
    if fault is not None:
        raise ServeError(f"{key}: replica fault: {fault}")
    if reclaimed:
        raise node_agent.pod_drained_class(stop)(
            f"{key}: replica drained on reclaim notice"
        )


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class ServeClient:
    """Round-robin client over a TPUServe's Ready replicas (a copy of the
    reference's). Discovery is a pod list through the clientset (the
    port's serve labels); dispatch goes through this module's replica
    table. Draining and vanished replicas are retried on another replica
    (the zero-failed-requests rollout contract). ``Overloaded`` is
    backpressure and is honored: the client backs off for the shedder's
    ``retry_after_s`` hint (jittered) and retries inside the caller's
    deadline; only when the deadline can't absorb the backoff does it
    propagate."""

    #: base backoff when a shed carries no retry_after_s hint
    OVERLOAD_BACKOFF_S = 0.05

    def __init__(self, clientset, name: str, namespace: str = "default",
                 cache_ttl_s: float = 0.25):
        self._cs = clientset
        self.name = name
        self.namespace = namespace
        self._rr = 0
        self._cache: Tuple[float, List[str]] = (0.0, [])
        self._cache_ttl = cache_ttl_s
        self._lock = threading.Lock()

    def ready_replica_keys(self, refresh: bool = False) -> List[str]:
        from tfk8s_tpu_torch.trainer import labels as L

        with self._lock:
            ts, cached = self._cache
            if not refresh and cached and time.monotonic() - ts < self._cache_ttl:
                return list(cached)
        pods, _rv = self._cs.pods(self.namespace).list(
            label_selector=L.serve_selector(self.name)
        )
        keys = sorted(p.metadata.key for p in pods if replica_is_ready(p))
        with self._lock:
            self._cache = (time.monotonic(), keys)
        return keys

    def request(self, payload: Any, timeout: float = 30.0,
                traceparent: Optional[str] = None, tenant: str = "",
                priority: int = 0) -> Any:
        deadline = time.monotonic() + timeout
        refresh = False
        backoff = 0.02
        shed_backoff = self.OVERLOAD_BACKOFF_S
        attempt = 0
        # the ambient span (or the one the traceparent continues) carries
        # the retry timeline
        span = _trace.get_tracer().current_span()
        if traceparent is None and span is not None:
            traceparent = span.traceparent
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise DeadlineExceeded(
                    f"no replica of {self.namespace}/{self.name} served the "
                    f"request within {timeout}s"
                )
            keys = self.ready_replica_keys(refresh=refresh)
            refresh = False
            targets = [k for k in keys if lookup_replica(k) is not None]
            if not targets:
                # exponential backoff while no replica is routable
                time.sleep(min(backoff, max(remaining, 0.0)))
                backoff = min(backoff * 2, 0.5)
                refresh = True
                continue
            backoff = 0.02
            with self._lock:
                self._rr += 1
                key = targets[self._rr % len(targets)]
            server = lookup_replica(key)
            if server is None:
                refresh = True
                continue
            attempt += 1
            try:
                return server.submit(
                    payload, timeout=remaining, traceparent=traceparent,
                    tenant=tenant, priority=priority,
                )
            except Draining:
                # replica is rolling out from under us: retry elsewhere
                if span is not None:
                    span.add_event("retry", {
                        "attempt": attempt, "reason": "Draining",
                        "replica": key, "backoff_s": 0.0,
                    })
                refresh = True
                continue
            except ReplicaUnavailable:
                # the replica died holding the request: idempotent serve,
                # safe to re-dispatch to a survivor inside the deadline
                if span is not None:
                    span.add_event("retry", {
                        "attempt": attempt, "reason": "ReplicaUnavailable",
                        "replica": key, "backoff_s": 0.0,
                    })
                refresh = True
                continue
            except Overloaded as exc:
                delay = jittered_backoff(exc.retry_after_s, shed_backoff)
                if delay >= deadline - time.monotonic():
                    # the deadline can't absorb the backoff: surface the
                    # shed rather than burn the wait and time out anyway
                    raise
                if span is not None:
                    span.add_event("retry", {
                        "attempt": attempt, "reason": "Overloaded",
                        "replica": key, "backoff_s": delay,
                    })
                time.sleep(delay)
                shed_backoff = min(shed_backoff * 2, 1.0)
                refresh = True


def jittered_backoff(retry_after_s: Optional[float], fallback_s: float) -> float:
    """Turn a shedder's Retry-After hint (or a client-side fallback) into
    an actual sleep: uniformly jittered over [0.5x, 1.5x] so shed callers
    decorrelate instead of re-arriving in lockstep at the hinted instant."""
    import random

    base = retry_after_s if retry_after_s and retry_after_s > 0 else fallback_s
    return base * (0.5 + random.random())


def template_hash(wire_fragment: Any) -> str:
    """Stable short hash of a wire-form spec fragment: the pod-template
    version identity rolling updates key off (the reference's, so one
    manifest hashes alike in both packages)."""
    import hashlib
    import json

    blob = json.dumps(wire_fragment, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:10]

"""Runtime uniformity seam (counterpart of
:mod:`apex_tpu.resilience.uniformity`): cross-process divergence
becomes a named error instead of a device-side deadlock.

A multi-process run is one program launched once a rank.  Every
decision that shapes the collectives a step issues (which bucket plan
ZeRO builds, which scheduler config a server takes) must come out the
same on every rank: one divergent rank issues another NCCL sequence,
and every rank then waits in its own next collective for good.

- :func:`assert_uniform(tag, value) <assert_uniform>` records by
  default: it digests ``value``, stores it under ``tag`` and returns.
  It issues no collective, since call counts diverge in exactly the
  runs this seam exists to catch.
- :func:`check_uniform` is the synchronization point: one gather of
  every rank's recorded decisions, then :class:`UniformityError` on
  the first tag whose digests differ, tags that only some ranks
  recorded included.  Call it at a point every rank reaches: after
  init, after a plan build, every N steps (:class:`UniformityMonitor`).
- ``gather=`` / :func:`install_gather` inject the transport (tests pass
  a fake gather of divergent views).  The default is
  ``torch.distributed.all_gather_object`` over the world group, and a
  local no-op when no group of more than one rank is up.

:func:`uniform_digest` is the JAX package's byte for byte (JSON with
sorted keys, sha256, 16 hex characters), so both packages' digests of
one Python value are equal.
"""

import hashlib
import json
import logging
import threading
from typing import Callable, Dict, List, Optional

from apex_tpu_torch.utils.logging import get_logger, log_structured

logger = get_logger(__name__)

__all__ = [
    "UniformityError", "UniformityMonitor", "assert_uniform",
    "check_uniform", "install_gather", "recorded_decisions",
    "register_uniform", "reset_uniformity", "uniform_digest",
]


class UniformityError(RuntimeError):
    """A cross-process decision diverged.  ``tag`` names the decision;
    ``views`` is the per-process digest list that disagreed."""

    def __init__(self, tag: str, views: List[Optional[str]]):
        self.tag = tag
        self.views = list(views)
        per_rank = ", ".join(
            f"process {i}: {v if v is not None else '<never recorded>'}"
            for i, v in enumerate(views))
        super().__init__(
            f"cross-process divergence on decision '{tag}': {per_rank} "
            f"— on a real pod this lowers different collective "
            f"schedules and wedges every host device-side; fix the "
            f"decision to be rank-uniform (thread it in as data) or "
            f"broadcast it from process 0 before use")


def uniform_digest(value) -> str:
    """Canonical short digest of a decision value: JSON with sorted
    keys (sets sorted, numpy and torch values by ``tolist``, unknown
    types via ``repr``), sha256, 16 hex chars.  Stable across processes for equal logical values — the
    thing :func:`assert_uniform` records and compares."""
    def _default(obj):
        if isinstance(obj, (set, frozenset)):
            return sorted(obj, key=repr)
        if isinstance(obj, bytes):
            return obj.hex()
        if hasattr(obj, "tolist"):        # numpy scalars/arrays
            return obj.tolist()
        return repr(obj)

    blob = json.dumps(value, sort_keys=True, default=_default)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


_lock = threading.Lock()
_DECISIONS: Dict[str, str] = {}
_PROVIDERS: Dict[str, Callable[[], object]] = {}
_GATHER: Optional[Callable[[Dict[str, str]], List[Dict[str, str]]]] = None


def install_gather(fn) -> Optional[Callable]:
    """Install a transport for :func:`check_uniform`: a callable
    mapping this process's ``{tag: digest}`` payload to the list of
    every process's payload (index = process).  Pass None to restore
    the default (``all_gather_object`` over the world group, or a no-op
    on one rank).
    Returns the previously installed gather — the chaos harness and
    the tests use this seam to inject divergent per-rank views
    without a real multi-process run."""
    global _GATHER
    with _lock:
        prev, _GATHER = _GATHER, fn
    return prev


def reset_uniformity() -> None:
    """Clear recorded decisions, providers, and any installed gather
    (test isolation)."""
    global _GATHER
    with _lock:
        _DECISIONS.clear()
        _PROVIDERS.clear()
        _GATHER = None


def recorded_decisions() -> Dict[str, str]:
    """Snapshot of this process's recorded ``{tag: digest}`` map."""
    with _lock:
        return dict(_DECISIONS)


def assert_uniform(tag: str, value, *, gather=None) -> str:
    """Record a decision that must be identical on every process.

    Digests ``value`` and stores it under ``tag`` (last write wins —
    re-deciding is fine as long as every process re-decides the same
    way).  Performs NO collective: divergent runs diverge in call
    counts too, and a per-call gather would wedge exactly when it
    mattered.  The comparison happens at :func:`check_uniform`.

    ``gather=`` forces an eager check of just this tag through the
    given transport — the test/chaos spelling.  Returns the digest."""
    digest = uniform_digest(value)
    with _lock:
        _DECISIONS[tag] = digest
        g = gather if gather is not None else _GATHER
    if g is not None:
        _compare({tag: digest}, g({tag: digest}))
    return digest


def register_uniform(tag: str, provider: Callable[[], object]) -> None:
    """Register a zero-arg provider evaluated at every
    :func:`check_uniform` — for decisions best re-read at check time
    (registry status, plan fingerprints) rather than recorded once."""
    with _lock:
        _PROVIDERS[tag] = provider


def _default_gather(payload: Dict[str, str]) -> List[Dict[str, str]]:
    """Every rank's payload, by ``all_gather_object`` over the world
    group (index = rank); just this one without a group of two or more."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized() or dist.get_world_size() <= 1:
        return [dict(payload)]
    views: List[Optional[Dict[str, str]]] = [None] * dist.get_world_size()
    dist.all_gather_object(views, dict(payload))
    return [dict(v) for v in views]


def _compare(local: Dict[str, str],
             views: List[Dict[str, str]]) -> None:
    tags = sorted({t for v in views for t in v})
    for tag in tags:
        per_rank = [v.get(tag) for v in views]
        if len(set(per_rank)) > 1:
            log_structured(logger, logging.ERROR,
                           "uniformity_divergence", tag=tag,
                           views=per_rank)
            raise UniformityError(tag, per_rank)


def check_uniform(*, gather=None) -> Dict[str, str]:
    """The synchronization point: evaluate registered providers,
    gather every process's recorded decisions (one bounded
    allgather), and raise :class:`UniformityError` on the first tag
    whose digests differ across processes — including tags only SOME
    processes recorded, which is the divergent-call-count shape a
    per-call check could never report.  Single-process (and no
    installed gather): compares a single view, i.e. a no-op.
    Returns this process's ``{tag: digest}`` payload."""
    with _lock:
        providers = dict(_PROVIDERS)
    for tag, provider in providers.items():
        assert_uniform(tag, provider())
    with _lock:
        payload = dict(_DECISIONS)
        g = gather if gather is not None else _GATHER
    views = (g or _default_gather)(payload)
    _compare(payload, views)
    return payload


class UniformityMonitor:
    """Cadenced :func:`check_uniform`: ``on_step(step)`` checks every
    ``every_n_steps``-th step — a naturally-synchronous point, since
    every process runs the same step loop.  The step index itself is
    recorded, so a rank that slipped a step fails the check by
    construction."""

    def __init__(self, every_n_steps: int = 100, *, gather=None):
        if every_n_steps < 1:
            raise ValueError("every_n_steps must be >= 1")
        self.every_n_steps = int(every_n_steps)
        self._gather = gather

    def on_step(self, step: int) -> Optional[Dict[str, str]]:
        if step % self.every_n_steps != 0:
            return None
        assert_uniform("uniformity.monitor_step", int(step))
        return check_uniform(gather=self._gather)

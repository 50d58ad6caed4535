"""Request journal — the frontend's replay source of last resort
(counterpart of :mod:`apex_tpu.inference.fleet.journal`).

Every request the fleet accepts is journaled BEFORE it reaches a
replica: the original request (prompt, budget, lane, trace id), which
replica owns it, and — updated as the frontend polls replica progress —
every token already streamed to the caller.  On a replica wedge the
richer ``serve.step_wedged`` manifest drives replay; on a hard kill
(SIGKILL, OOM — no manifest, no goodbye) this journal is the ONLY
record of what the caller was owed, and the splice invariant below is
what makes the replayed stream gapless and duplicate-free.

The splice invariant
--------------------
A request may be served by several LEGS (original admission, replays,
a hedge) across several replicas.  Per entry:

- ``emitted`` is the tokens already streamed to the caller, in order —
  the single source of truth for "what the caller has seen".
- ``leg_prefix`` is the frozen copy of ``emitted`` taken when the
  CURRENT leg was submitted; the leg's continuation prompt is
  ``request.prompt + leg_prefix``, so every token the leg produces is
  a position ``>= len(leg_prefix)`` of the caller's stream.
- :meth:`JournalEntry.splice` maps a leg-relative token list back to
  stream positions (``leg_prefix + leg_tokens``) and appends only the
  tokens past ``len(emitted)`` — re-polling, a replay that regenerates
  a few already-seen tokens, or a hedge racing the primary can never
  emit a duplicate, and a leg that is AHEAD of the journal (the wedge
  manifest captures tokens the frontend never polled) streams exactly
  the missing tail.

With greedy decoding a continuation leg's tokens are bitwise the
tokens the dead leg would have produced (argmax is independent of
batch composition), so the spliced stream is token-identical to an
unkilled run — the acceptance bar of the fleet chaos tests.
"""

import dataclasses
from typing import Dict, List, Optional, Sequence

from apex_tpu_torch.inference.scheduler import Request

__all__ = ["FleetCompletion", "JournalEntry", "RequestJournal"]


@dataclasses.dataclass
class FleetCompletion:
    """A finished request as the CALLER saw it: the original prompt,
    the full spliced token stream (across every leg), and the fleet's
    cost columns — how many replay legs (``replays``) and whether a
    hedge copy ran (``hedged``).  ``replica_id`` is the replica that
    emitted the final token."""

    rid: int
    prompt: List[int]
    tokens: List[int]
    submit_time: float
    finish_time: float
    token_times: List[float]
    lane: str = "interactive"
    replica_id: str = ""
    replays: int = 0
    hedged: bool = False
    trace_id: Optional[str] = None


@dataclasses.dataclass
class JournalEntry:
    """One accepted request's replay state (see the module docstring
    for the ``emitted`` / ``leg_prefix`` splice invariant)."""

    request: Request               # the ORIGINAL request, prompt copied
    submit_time: float
    owner: str                     # replica currently serving it
    leg_prefix: List[int]          # emitted snapshot at current leg start
    emitted: List[int]             # tokens streamed to the caller
    token_times: List[float]
    replays: int = 0
    hedge_owner: Optional[str] = None  # live hedge copy's replica
    hedged: bool = False               # a hedge ever ran
    done: bool = False

    def splice(self, leg_tokens: Sequence[int],
               leg_times: Optional[Sequence[float]] = None,
               now: float = 0.0) -> List[int]:
        """Merge a leg-relative token list into the caller's stream:
        append (and return) only the tokens past what was already
        emitted.  ``leg_times`` aligns per-token times when the leg
        reports them (a drained ``Completion``); manifest/poll sources
        stamp ``now``."""
        total = list(self.leg_prefix) + list(leg_tokens)
        new = total[len(self.emitted):]
        if not new:
            return []
        start = len(self.emitted) - len(self.leg_prefix)
        for j, tok in enumerate(new):
            self.emitted.append(int(tok))
            self.token_times.append(
                float(leg_times[start + j]) if leg_times is not None
                else float(now))
        return new

    def finished(self) -> bool:
        """The caller's stream is complete: budget exhausted or the
        last emitted token is the eos — checked at every splice so a
        request that FINISHED in the very step its replica died is
        finalized from the journal instead of replayed past its end."""
        req = self.request
        if len(self.emitted) >= req.max_new_tokens:
            return True
        return (req.eos_id is not None and bool(self.emitted)
                and self.emitted[-1] == req.eos_id)

    def remaining(self) -> int:
        return self.request.max_new_tokens - len(self.emitted)


class RequestJournal:
    """rid -> :class:`JournalEntry`, insertion-ordered.  Entries stay
    after completion (``done=True``) so a late duplicate — a suppressed
    hedge loser's eviction, a replayed completion landing after the
    journal already finalized — is recognized and dropped."""

    def __init__(self):
        self._entries: Dict[int, JournalEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def add(self, request: Request, owner: str,
            submit_time: float) -> JournalEntry:
        if request.rid in self._entries \
                and not self._entries[request.rid].done:
            raise ValueError(
                f"rid {request.rid} is already journaled and unfinished")
        req = dataclasses.replace(request, prompt=list(request.prompt))
        entry = JournalEntry(
            request=req, submit_time=submit_time, owner=owner,
            leg_prefix=[], emitted=[], token_times=[])
        self._entries[request.rid] = entry
        return entry

    def get(self, rid: int) -> Optional[JournalEntry]:
        return self._entries.get(rid)

    def unfinished(self) -> List[JournalEntry]:
        return [e for e in self._entries.values() if not e.done]

    def owned_by(self, replica_id: str) -> List[JournalEntry]:
        """Unfinished entries whose primary OR hedge leg runs on
        ``replica_id`` — the set a replica death orphans."""
        return [e for e in self._entries.values() if not e.done
                and (e.owner == replica_id
                     or e.hedge_owner == replica_id)]

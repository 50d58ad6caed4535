"""Speculative decode: n-gram (prompt-lookup) drafting and acceptance.

Counterpart of :mod:`apex_tpu.inference.spec`, a copy of its host-side
Python (this package imports nothing from the JAX one).  A model-free
proposer guesses the next ``k`` tokens of each resident sequence from
its own context (prompt + generated so far), and one batched verify
step (:func:`apex_tpu_torch.inference.decode.make_verify_step`) scores
all ``k + 1`` positions through the paged attention kernel's
``width > 1`` layout.

**Prompt-lookup drafting** (:class:`NGramProposer`): find the most
recent PRIOR occurrence of the context's trailing n-gram (n swept
``ngram_max .. ngram_min``) and propose the ``k`` tokens that followed
it.  It pays off on self-repetitive text (extraction, quoting, code
echoing its own identifiers); on high-entropy text a missed draft costs
one wasted verify column.

**Acceptance** (:func:`accepted_tokens`) is the longest-matching-
prefix rule: the verify step returns the sampling head's token at
every position; draft column ``j`` survives iff it equals the head's
emission at column ``j - 1``, and the first mismatch position's own
head token is emitted as the (always-correct) bonus.  Every consumed
emission is therefore conditioned on a verified-correct prefix and
spends the same per-(slot, draw) seed the plain decode step would
have: the emitted stream equals the non-speculative stream bitwise,
greedy and sampled alike.  A draft can only add tokens, never change
them.
"""

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["NGramProposer", "accepted_tokens"]


class NGramProposer:
    """Per-sequence prompt-lookup draft source.

    Keeps the sequence's full token context plus an incrementally
    maintained index of every n-gram's two most recent end positions
    (for each n in ``[ngram_min, ngram_max]``) — ``propose`` is O(1)
    per n, ``extend`` is O(tokens * n-grams).  The two-deep history
    matters: the context's own trailing n-gram is always the MOST
    recent occurrence of itself, so the draft continuation comes from
    the one before it.
    """

    def __init__(self, draft_len: int, ngram_max: int = 3,
                 ngram_min: int = 1):
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1 (got {draft_len})")
        if not (1 <= ngram_min <= ngram_max):
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"({ngram_min}, {ngram_max})")
        self.draft_len = int(draft_len)
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)
        self._tokens: List[int] = []
        #: gram -> end position (exclusive) of its latest occurrence
        self._latest: Dict[Tuple[int, ...], int] = {}
        #: gram -> end position of the occurrence BEFORE the latest
        self._prior: Dict[Tuple[int, ...], int] = {}

    def __len__(self) -> int:
        return len(self._tokens)

    def extend(self, tokens: Sequence[int]) -> None:
        """Append emitted (or prompt) tokens, indexing every trailing
        n-gram they complete."""
        for t in tokens:
            self._tokens.append(int(t))
            end = len(self._tokens)
            for n in range(self.ngram_min, self.ngram_max + 1):
                if end < n:
                    break
                gram = tuple(self._tokens[end - n:end])
                old = self._latest.get(gram)
                if old is not None:
                    self._prior[gram] = old
                self._latest[gram] = end

    def propose(self) -> List[int]:
        """Up to ``draft_len`` draft tokens (possibly empty: no prior
        occurrence of any trailing n-gram).  Longest n wins — a longer
        matched context is a stronger continuation signal."""
        end = len(self._tokens)
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if end < n:
                continue
            gram = tuple(self._tokens[end - n:end])
            pos = self._latest.get(gram)
            if pos == end:  # the trailing gram itself — use the prior one
                pos = self._prior.get(gram)
            if pos is None or pos >= end:
                continue
            return self._tokens[pos:pos + self.draft_len]
        return []


def accepted_tokens(drafted: Sequence[int], sampled: Sequence[int],
                    ) -> List[int]:
    """The emissions one verify step yields for one slot.

    ``drafted``: the verify step's input row ``[current, d1 .. dk]``;
    ``sampled``: its output row (the sampling head's token at each
    verified position).  Emission ``j`` is ``sampled[j]``; it is
    consumed only while every draft before it matched — draft
    ``drafted[j]`` survives iff it equals ``sampled[j - 1]`` — so the
    first mismatch contributes its own (correct) head token and stops.
    Always emits at least one token; at most ``len(drafted)``.
    """
    emit = [int(sampled[0])]
    for j in range(1, len(drafted)):
        if int(drafted[j]) != int(sampled[j - 1]):
            break
        emit.append(int(sampled[j]))
    return emit

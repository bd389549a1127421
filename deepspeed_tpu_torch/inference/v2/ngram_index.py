"""Incremental n-gram occurrence index for prompt-lookup drafting.

Port of ``deepspeed_tpu/inference/v2/ngram_index.py`` (host-side, a copy).
``InferenceEngineV2._lookup_draft`` finds the most recent earlier
occurrence of the history's trailing n-gram by scanning the last
``window`` tokens right-to-left: O(window * ngram) pure Python per
speculative round, the cost the engine's ``_SPEC_SCAN_WINDOW`` bounds.
:class:`NGramIndex` replaces the scan with a dict of occurrence positions
per n-gram, updated as tokens append: O(ngram) per append, O(ngram + log
occ) per draft lookup, and by construction the scan's answer (window
bound included; tests/test_torch_speculative.py holds both against the
JAX package's).
"""

from bisect import bisect_left
from typing import Dict, List, Tuple


class NGramIndex:
    """Occurrence positions of every 2..max_n-gram of a growing token
    sequence. Histories only ever grow in the speculative decode loop
    (KV rollback rewinds cache positions, never the emitted rows) —
    ``sync`` leans on that append-only contract to ADOPT the caller's
    row by reference rather than copying it; the index itself adds only
    the gram dict."""

    def __init__(self, max_n: int, window: int):
        self.max_n = max(int(max_n), 2)
        self.window = int(window)
        self.tokens: List[int] = []
        self._indexed = 0          # tokens of self.tokens indexed so far
        # n-gram tuple -> ascending start positions of its LAST TWO
        # occurrences. Two suffice for exactness under the
        # index-then-draft usage: at draft time the trailing gram's
        # latest occurrence IS the tail, the candidate is the one before
        # it, and anything older is even further outside the window.
        # Keys are bounded by the distinct grams in the history (itself
        # bounded by max_seq_len), positions by 2 per gram.
        self._occ: Dict[Tuple[int, ...], List[int]] = {}

    def extend(self, toks) -> None:
        self.tokens.extend(int(t) for t in toks)
        self._index_tail()

    def append(self, tok) -> None:
        self.tokens.append(int(tok))
        self._index_tail()

    def sync(self, history: List[int]) -> None:
        """Adopt ``history`` (the engine's prompt+generated row) by
        reference and index whatever lies beyond the indexed prefix.
        Valid because rows only append — the invariant the engine's
        speculative loop maintains."""
        self.tokens = history
        self._index_tail()

    def _index_tail(self) -> None:
        toks = self.tokens
        while self._indexed < len(toks):
            self._indexed += 1
            i = self._indexed
            for n in range(2, self.max_n + 1):
                if i >= n:
                    occ = self._occ.setdefault(tuple(toks[i - n:i]), [])
                    occ.append(i - n)
                    if len(occ) > 2:
                        del occ[0]

    def has_candidate(self, ngram: int) -> bool:
        """Whether :meth:`draft` would find a candidate right now (any
        matching trailing n-gram inside the window) — the speculation
        chooser's cheap repetitiveness prior before either source has
        accept-rate history for a request."""
        return bool(self.draft(1, ngram))

    def draft(self, k: int, ngram: int) -> List[int]:
        """The k tokens that followed the most recent earlier occurrence
        of the trailing n-gram (n = ngram..2, longest first), with both
        the tail and the matched occurrence inside the trailing
        ``window`` tokens — byte-for-byte the ``_lookup_draft`` scan."""
        if k <= 0:
            return []
        self._index_tail()
        toks = self.tokens
        L = len(toks)
        base = max(0, L - self.window)
        for n in range(min(ngram, self.max_n), 1, -1):
            if L - base <= n:
                continue
            occ = self._occ.get(tuple(toks[L - n:]))
            if not occ:
                continue
            # latest occurrence strictly left of the tail itself...
            j = bisect_left(occ, L - n) - 1
            # ...and starting inside the scan window
            if j >= 0 and occ[j] >= base:
                start = occ[j] + n
                return [int(t) for t in toks[start:start + k]]
        return []

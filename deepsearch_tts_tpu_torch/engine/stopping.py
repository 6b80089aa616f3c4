"""Stop-condition scanning for streamed token output (port of
``engine/stopping.py``; host code, the same behaviour).

Stop *sequences* that may span token boundaries, the
``include_stop_str_in_output`` flag, EOS token ids and max-token budgets.
Each check scans only the tail of the decoded text.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class StopState:
    """Per-sequence incremental stop scanner."""

    stop_sequences: tuple[str, ...] = ()
    eos_ids: tuple[int, ...] = ()
    max_tokens: int = 16384
    include_stop_str: bool = False

    text: str = ""
    n_tokens: int = 0
    finished: bool = False
    finish_reason: str | None = None

    def _max_stop_len(self) -> int:
        return max((len(s) for s in self.stop_sequences), default=0)

    def feed(self, token_id: int, piece: str) -> bool:
        """Feed one decoded token; True if the sequence just finished. On a
        stop-sequence hit the text is cut at (or, with ``include_stop_str``,
        after) the match."""
        if self.finished:
            return False
        self.n_tokens += 1
        if token_id in self.eos_ids:
            self.finished, self.finish_reason = True, "stop"
            return True
        prev_len = len(self.text)
        self.text += piece
        if self.stop_sequences:
            window_start = max(0, prev_len - self._max_stop_len() + 1)
            window = self.text[window_start:]
            for s in self.stop_sequences:
                idx = window.find(s)
                if idx >= 0:
                    cut = window_start + idx + (len(s) if self.include_stop_str else 0)
                    self.text = self.text[:cut]
                    self.finished, self.finish_reason = True, "stop"
                    return True
        if self.n_tokens >= self.max_tokens:
            self.finished, self.finish_reason = True, "length"
            return True
        return False

"""Greedy longest-prefix-match tokenizer.

Behavioral parity with the reference tokenizer
(``src/tokenizer.{h,cpp}`` of the C++ system): not true BPE — the vocab is matched
greedily by longest prefix over a byte trie, with 256 byte-fallback tokens
anchored at the ``<0x00>`` vocab entry, eot detection among
``<|eot_id|>`` / ``<|end|>`` / ``<|im_end|>``, and a leading space stripped
when decoding the token immediately after BOS.

The trie here is a flat transition table over bytes (array-based DAWG-style),
which makes encode O(len) with small constants in pure Python. This is the
port's copy of ``deepseek_tpu/tokenizer.py`` without its native fast path.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from deepseek_tpu_torch.utils.codec import CheckpointData, unpack_tokenizer_tokens

_EOT_STRINGS = (b"<|eot_id|>", b"<|end|>", b"<|im_end|>")


class Tokenizer:
    def __init__(self, vocab: Sequence[bytes], bos_id: int, eos_id: int):
        self.vocab: List[bytes] = list(vocab)
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.eot_id = -1
        self.byte_fallback_start = -1
        for i, piece in enumerate(self.vocab):
            if piece == b"<0x00>" and i + 256 <= len(self.vocab):
                self.byte_fallback_start = i
            elif piece in _EOT_STRINGS:
                self.eot_id = i

        # trie: list of dict[byte -> node index]; token id at node or -1
        self._children: List[Dict[int, int]] = [{}]
        self._token_at: List[int] = [-1]
        for tid, piece in enumerate(self.vocab):
            node = 0
            for b in piece:
                nxt = self._children[node].get(b)
                if nxt is None:
                    nxt = len(self._children)
                    self._children[node][b] = nxt
                    self._children.append({})
                    self._token_at.append(-1)
                node = nxt
            self._token_at[node] = tid

    @classmethod
    def from_checkpoint(cls, data: CheckpointData) -> "Tokenizer":
        vocab = unpack_tokenizer_tokens(data["tokenizer.tokens"])
        return cls(
            vocab,
            bos_id=int(data.metadata["bos_token_id"]),
            eos_id=int(data.metadata["eos_token_id"]),
        )

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text, bos: bool = False) -> List[int]:
        """Greedy longest-prefix-match encode (tokenizer.cpp:57-94)."""
        if isinstance(text, str):
            data = text.encode("utf-8")
        else:
            data = bytes(text)
        out: List[int] = []
        if bos:
            out.append(self.bos_id)
        children = self._children
        token_at = self._token_at
        i = 0
        n = len(data)
        while i < n:
            node = 0
            valid_tid = -1
            valid_len = 0
            j = i
            while j < n:
                nxt = children[node].get(data[j])
                if nxt is None:
                    break
                node = nxt
                j += 1
                tid = token_at[node]
                if tid >= 0:
                    valid_tid = tid
                    valid_len = j - i
            if valid_tid < 0:
                # no vocab word matches any prefix; byte fallback
                if self.byte_fallback_start >= 0:
                    out.append(data[i] + self.byte_fallback_start)
                i += 1
            else:
                out.append(valid_tid)
                i += valid_len
        return out

    def decode_one(self, prev_token: int, token: int) -> bytes:
        """Decode a single token given its predecessor (tokenizer.cpp:44-55)."""
        piece = self.vocab[token]
        if prev_token == self.bos_id and piece.startswith(b" "):
            return piece[1:]
        if (self.byte_fallback_start >= 0
                and token >= self.byte_fallback_start
                and token - self.byte_fallback_start < 256):
            return bytes([token - self.byte_fallback_start])
        return piece

    def decode(self, tokens: Sequence[int]) -> bytes:
        out = []
        prev = -1
        for t in tokens:
            out.append(self.decode_one(prev, t))
            prev = t
        return b"".join(out)

    def encoding_to_debug_string(self, encoding: Sequence[int]) -> str:
        parts = []
        for tid in encoding:
            if tid == self.bos_id:
                parts.append(f"[<s>:{tid}]")
            elif tid == self.eos_id:
                parts.append(f"[</s>:{tid}]")
            else:
                parts.append("[" + self.vocab[tid].decode("utf-8", errors="replace") + f":{tid}]")
        return "".join(parts)

    def is_eos_or_eot(self, token: int) -> bool:
        return token == self.eos_id or token == self.eot_id

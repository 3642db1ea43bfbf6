"""A byte-level BPE tokenizer, RoBERTa's (the CLAP text tower's), read from its files without
``transformers`` or ``tokenizers``, neither of which the card's machine has.

It reads ``vocab.json`` + ``merges.txt``, or a ``tokenizer.json`` whose ``model.type`` is
``BPE`` under a ``ByteLevel`` pre-tokenizer; any other tokenizer raises. A prompt is split by
GPT-2's pattern (contractions, letter runs, number runs, other-symbol runs, whitespace),
each piece's UTF-8 bytes are mapped to printable characters, merged by rank, and the pieces
are looked up in the vocabulary (unknown pieces take ``<unk>``). Then RoBERTa's template
``<s> ... </s>``, truncation and right padding, with the call and the outputs of
``transformers.AutoTokenizer``. Special-token strings inside a prompt are not split out.

``re`` has no ``\\p{L}`` or ``\\p{N}``: the letter and number classes are built once from
``unicodedata``'s categories (L* and N*).
"""

from __future__ import annotations

import json
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character map."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _class_ranges(prefix: str) -> str:
    """A regex character class body covering every code point whose Unicode category
    starts with ``prefix``."""
    parts, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            parts.append(re.escape(chr(start)) + ("-" + re.escape(chr(prev))
                                                  if prev > start else ""))
            start = None
    if start is not None:
        parts.append(re.escape(chr(start)) + "-" + re.escape(chr(prev)))
    return "".join(parts)


@lru_cache(maxsize=1)
def _pattern() -> "re.Pattern":
    letters, numbers = _class_ranges("L"), _class_ranges("N")
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+"
        rf"| ?[^\s{letters}{numbers}]+|\s+(?!\S)|\s+")


class ByteLevelBPETokenizer:
    """RoBERTa's tokenizer from its vocabulary and ranked merges."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 bos: str = "<s>", eos: str = "</s>", pad: str = "<pad>", unk: str = "<unk>",
                 add_prefix_space: bool = False):
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        missing = [t for t in (bos, eos, pad, unk) if t not in vocab]
        if missing:
            raise ValueError(f"the vocabulary has no special tokens {missing}")
        self.bos_id, self.eos_id = vocab[bos], vocab[eos]
        self.pad_token_id, self.unk_id = vocab[pad], vocab[unk]
        self.add_prefix_space = add_prefix_space
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, piece: str) -> List[str]:
        if piece in self._cache:
            return self._cache[piece]
        word = list(piece)
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[piece] = word
        return word

    def encode(self, text: str) -> List[int]:
        """Token ids of one text, without the template's special tokens."""
        if self.add_prefix_space and text and not text[0].isspace():
            text = " " + text
        byte_map = _bytes_to_unicode()
        ids = []
        for piece in _pattern().findall(text):
            mapped = "".join(byte_map[b] for b in piece.encode("utf-8"))
            ids.extend(self.vocab.get(tok, self.unk_id) for tok in self._bpe(mapped))
        return ids

    def __call__(self, prompts: Sequence[str], padding=True, truncation=True,
                 max_length: Optional[int] = None, return_tensors: str = "np"):
        """{"input_ids", "attention_mask"} int64 [N, L]: ``<s> ids </s>`` per prompt, the
        ids cut to ``max_length - 2`` with ``truncation``, rows right-padded to the longest
        with ``padding``."""
        if return_tensors != "np":
            raise ValueError(f"return_tensors={return_tensors!r}: only 'np' is supported")
        rows = []
        for p in prompts:
            ids = self.encode(p)
            if truncation and max_length is not None:
                ids = ids[:max(max_length - 2, 0)]
            rows.append([self.bos_id] + ids + [self.eos_id])
        if not padding and len({len(r) for r in rows}) > 1:
            raise ValueError("rows of different lengths need padding=True")
        width = max(len(r) for r in rows)
        input_ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            input_ids[i, :len(r)], mask[i, :len(r)] = r, 1
        return {"input_ids": input_ids, "attention_mask": mask}


def _special(path: str, name: str, default: str) -> str:
    cfg = os.path.join(path, "tokenizer_config.json")
    if not os.path.exists(cfg):
        return default
    with open(cfg) as f:
        tok = json.load(f).get(name, default)
    return tok["content"] if isinstance(tok, dict) else (tok or default)


def load_tokenizer(path: str) -> ByteLevelBPETokenizer:
    """A tokenizer directory (or a ``tokenizer.json`` file) -> ``ByteLevelBPETokenizer``.
    A directory's ``tokenizer.json`` wins over its ``vocab.json`` + ``merges.txt``."""
    tok_json = path if path.endswith(".json") else os.path.join(path, "tokenizer.json")
    directory = os.path.dirname(tok_json)
    names = {n: _special(directory, f"{n}_token", d)
             for n, d in (("bos", "<s>"), ("eos", "</s>"), ("pad", "<pad>"), ("unk", "<unk>"))}
    if os.path.exists(tok_json):
        with open(tok_json, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec.get("model", {})
        if model.get("type") != "BPE":
            raise ValueError(f"{tok_json}: tokenizer model {model.get('type')!r}; only a "
                             "byte-level BPE (RoBERTa's) is supported")
        pre = spec.get("pre_tokenizer") or {}
        levels = pre.get("pretokenizers", [pre]) if pre.get("type") == "Sequence" else [pre]
        byte_level = [p for p in levels if p.get("type") == "ByteLevel"]
        if not byte_level:
            raise ValueError(f"{tok_json}: pre-tokenizer {pre.get('type')!r}; only ByteLevel "
                             "is supported")
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges", [])]
        post = spec.get("post_processor") or {}
        if post.get("type") in ("RobertaProcessing", "BertProcessing"):
            names["bos"], names["eos"] = post["cls"][0], post["sep"][0]
        return ByteLevelBPETokenizer(
            model["vocab"], merges, **names,
            add_prefix_space=bool(byte_level[0].get("add_prefix_space", False)))
    vocab_file, merges_file = (os.path.join(path, n) for n in ("vocab.json", "merges.txt"))
    if not (os.path.exists(vocab_file) and os.path.exists(merges_file)):
        raise FileNotFoundError(f"no tokenizer.json, or vocab.json and merges.txt, under {path}")
    with open(vocab_file, encoding="utf-8") as f:
        vocab = json.load(f)
    with open(merges_file, encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = [tuple(line.split()) for line in lines
              if line.strip() and not line.startswith("#version")]
    return ByteLevelBPETokenizer(vocab, merges, **names)

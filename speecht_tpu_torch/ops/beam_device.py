"""CTC prefix beam search with n-gram LM shallow fusion, the whole batch on
the device (``--device-beam``).

Counterpart of ``speecht_tpu/ops/beam_device.py``. The host C++ beam
(``native/beam_search.cpp``) is the semantic oracle; this search mirrors
its scoring, including its per-frame top-k emission pruning:

  score = ln P_acoustic(prefix)
        + lm_weight * ln(10) * log10 P_LM(completed words)  [backoff n-gram]
        + word_count_weight * #words
        + valid_word_count_weight * #in-vocabulary-words

Two halves:

- **The LM tables (host, numpy).** The ARPA text or a KenLM PROBING binary
  (through ``native.kenlm_dump``) packs into bucketed hash tables: the
  unigrams direct-indexed by word id, every higher order in one arena of
  4-slot buckets with two-choice placement, and a word table keyed by a
  rolling hash of the partial word's characters. The build is the JAX
  package's, cuckoo walk and ``RandomState(0x5EED)`` included, so the
  tables come out bit-equal to JAX's. :meth:`DeviceLM.cached` keeps the
  finished tables in an npz keyed by the LM's and vocabulary's content.
  The tables then go to the device as torch tensors, after the budget
  check (``--device-lm-hbm-gb``).
- **The search.** :func:`make_device_beam_search` returns
  ``fn(logp, lengths, lm_weight, word_count_weight,
  valid_word_count_weight)``. For log-probs on the CPU it runs the plain
  version below: JAX's ``lax.scan`` over the frames with the rows as a
  batch dimension, the same packed F/U/I beam-state slabs and the same
  float32 arithmetic per frame. For log-probs on a CUDA device it launches
  ``csrc/beam_device.cu`` (``ops/beam_device_cuda.py``): one CTA per row
  with the whole frame loop inside, one launch a batch. There is no
  fallback between the two. Prefixes are identified by a dual 32-bit
  rolling hash; the only duplicate a CTC prefix beam can make,
  extend(p, c) == stay(j), is merged by a [W, W] match per frame; the top
  W of the (K+1)·W candidates are kept in ``lax.top_k``'s order (value
  descending, the lower index first on a tie), and a backpointer lattice
  gives the decoded ids.

u32 arithmetic is held in int64 and multiplied in 16-bit limbs, masked to
32 bits: no step relies on signed overflow. The scores are float32 as in
JAX; the host beam scores in float64, so the two can part on near ties.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from speecht_tpu_torch import vocabulary

NEG = -1.0e30  # the host beam's kNegInf (float32 -1e30 in every tensor)
_LN10 = 2.302585092994046
_MASK32 = 0xFFFFFFFF

# dual multiplicative prefix hash (uint32, wrapping)
_M1 = 16777619
_M2 = 2246822519
_SEED1 = 2166136261
_SEED2 = 3266489917
# separate seeds for the partial-word rolling hash
_WSEED1 = 374761393
_WSEED2 = 668265263
# FNV-1a-style n-gram key hash (two independent 32-bit streams)
_KP1 = 16777619
_KP2 = 2654435761
_KSEED1 = 2166136261
_KSEED2 = 40503

# KenLM's chained n-gram hash constants (kenlm_binary.cpp
# combine_word_hash), split into u32 halves
_KLM_C1 = 8978948897894561157
_KLM_C2 = 17894857484156487943
_C1HI, _C1LO = _KLM_C1 >> 32, _KLM_C1 & _MASK32
_C2HI, _C2LO = _KLM_C2 >> 32, _KLM_C2 & _MASK32

_SPACE = vocabulary.SPACE_ID
_BLANK = vocabulary.BLANK_ID


# -- hashes: numpy twins (table build) and torch (search) ---------------------


def _np_word_hash(ids: np.ndarray) -> tuple[np.uint32, np.uint32]:
    """Host twin of the in-search partial-word rolling hash."""
    h1 = np.uint32(_WSEED1)
    h2 = np.uint32(_WSEED2)
    with np.errstate(over="ignore"):
        for c in ids:
            u = np.uint32(c + 2)
            h1 = np.uint32(h1 * np.uint32(_M1) + u)
            h2 = np.uint32(h2 * np.uint32(_M2) + u)
    return h1, h2


def _np_key_hash_rows(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of the n-gram key hash over rows of ``ids`` [N, n]
    (a 1-D [n] sequence counts as one row); returns (k1, k2) uint32 [N]."""
    ids = np.atleast_2d(np.asarray(ids))
    k1 = np.full(ids.shape[0], _KSEED1, np.uint32)
    k2 = np.full(ids.shape[0], _KSEED2, np.uint32)
    with np.errstate(over="ignore"):
        for i in range(ids.shape[1]):
            u = ids[:, i].astype(np.uint32) + np.uint32(1)
            k1 = (k1 ^ u) * np.uint32(_KP1)
            k2 = (k2 ^ u) * np.uint32(_KP2)
    # (0, 0) marks empty slots; remap (collision probability ~2^-64)
    zero = (k1 == 0) & (k2 == 0)
    k2[zero] = np.uint32(1)
    return k1, k2


def _np_kenlm_key_hash_rows(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of :func:`_kenlm_key_hash` (exact u64 arithmetic) over
    rows of ``ids`` [N, n]; returns (lo, hi) uint32 [N]."""
    mask = (1 << 64) - 1
    ids = np.atleast_2d(np.asarray(ids))
    lo = np.zeros(ids.shape[0], np.uint32)
    hi = np.zeros(ids.shape[0], np.uint32)
    for r, row in enumerate(ids):
        h = int(row[0])
        for x in row[1:]:
            h = ((h * _KLM_C1) ^ ((1 + int(x)) * _KLM_C2)) & mask
        if h == 0:
            h = 1
        lo[r] = h & _MASK32
        hi[r] = h >> 32
    return lo, hi


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for u32 values held in int64: a's 16-bit limbs
    times b stay below 2^49, so nothing overflows."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _mul32_wide(a: torch.Tensor, b: int):
    """u32 x u32 -> the 64-bit product as a (hi, lo) pair of u32 in int64."""
    m16 = 0xFFFF
    a0, a1 = a & m16, a >> 16
    b0, b1 = b & m16, b >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    mid = (p00 >> 16) + (p01 & m16) + (p10 & m16)
    lo = (p00 & m16) | ((mid & m16) << 16)
    hi = (a1 * b1 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)) & _MASK32
    return hi, lo


def _key_hash(tok: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The n-gram key hash over ``tok`` [..., n] word ids (int64); returns
    (k1, k2), u32 in int64."""
    k1 = torch.full(tok.shape[:-1], _KSEED1, dtype=torch.int64, device=tok.device)
    k2 = torch.full(tok.shape[:-1], _KSEED2, dtype=torch.int64, device=tok.device)
    for i in range(tok.shape[-1]):
        u = (tok[..., i] + 1) & _MASK32
        k1 = _mul32(k1 ^ u, _KP1)
        k2 = _mul32(k2 ^ u, _KP2)
    zero = (k1 == 0) & (k2 == 0)
    return k1, torch.where(zero, 1, k2)


def _kenlm_key_hash(tok: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """KenLM's chained n-gram hash over ``tok`` [..., n] -> (lo, hi).

    h = (h * C1) ^ ((1 + next) * C2), wrapping u64, on u32 halves; the
    writer's key 0 -> 1 empty-slot remap is reproduced. (lo, hi) is the
    (k1, k2) layout of the tables :meth:`DeviceLM.from_binary` builds.
    """
    u = tok & _MASK32
    hhi = torch.zeros_like(u[..., 0])
    hlo = u[..., 0]
    for i in range(1, tok.shape[-1]):
        thi, tlo = _mul32_wide(hlo, _C1LO)
        thi = (thi + _mul32(hlo, _C1HI) + _mul32(hhi, _C1LO)) & _MASK32
        w = (u[..., i] + 1) & _MASK32
        whi, wlo = _mul32_wide(w, _C2LO)
        whi = (whi + _mul32(w, _C2HI)) & _MASK32
        hhi, hlo = thi ^ whi, tlo ^ wlo
    zero = (hhi == 0) & (hlo == 0)
    return torch.where(zero, 1, hlo), hhi


def _as_i32(k: torch.Tensor) -> torch.Tensor:
    """The int32 bit pattern of u32 values held in int64."""
    return (k - ((k >> 31) << 32)).to(torch.int32)


# -- the bucketed hash tables (host build) ------------------------------------


def _build_bucket_table(
    k1: np.ndarray, k2: np.ndarray, values: list[np.ndarray], slots: int = 4
) -> tuple[np.ndarray, np.ndarray, bool]:
    """Bucketed hash table, keys and values split (host build).

    Returns (keys int32 [NB, slots, 2], vals int32 [NB, slots,
    len(values)], two_choice), float values bit-cast. NB is a power of two
    sized for a mean load of about ``slots``/2. A key goes in bucket
    ``k1 % NB``; overflowing keys fall back to ``k2 % NB``, then a cuckoo
    walk places the residue. ``two_choice`` is False when every key landed
    in its primary bucket, so the probe reads one key row.
    """
    # dedup, keeping the LAST occurrence of a key (the host ArpaScorer's
    # map assignment for a duplicated n-gram)
    if len(k1):
        packed = (k1.astype(np.uint64) << np.uint64(32)) | k2.astype(np.uint64)
        _, first_of_rev = np.unique(packed[::-1], return_index=True)
        keep = np.sort(len(packed) - 1 - first_of_rev)
        if len(keep) != len(packed):
            k1, k2 = k1[keep], k2[keep]
            values = [np.asarray(v)[keep] for v in values]
    n = len(k1)
    nb = 1
    while nb * slots < max(2 * n, slots):
        nb *= 2
    while True:
        if nb > (1 << 28):  # > 1e9 slots: hash pathology, not table load
            raise ValueError(
                "bucket table cannot satisfy the slot bound; "
                "degenerate key distribution"
            )
        placed = _two_choice_place(k1, k2, nb, slots)
        if placed is not None:
            sb, slot = placed
            break
        nb *= 2  # the cuckoo walks did not converge (rare): grow and retry
    keys = np.zeros((nb, slots, 2), np.int32)
    vals = np.zeros((nb, slots, len(values)), np.int32)
    b1 = (k1 % np.uint32(nb)).astype(np.int64) if n else sb
    two_choice = bool(n) and bool((sb != b1).any())
    if n:
        keys[sb, slot, 0] = k1.view(np.int32)
        keys[sb, slot, 1] = k2.view(np.int32)
        for c, src in enumerate(values):
            src = np.asarray(src)
            if src.dtype == np.float32:
                src = src.view(np.int32)
            else:
                src = src.astype(np.int32)
            vals[sb, slot, c] = src
    return keys, vals, two_choice


def _two_choice_place(
    k1: np.ndarray, k2: np.ndarray, nb: int, slots: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Place every key in bucket ``k1 % nb`` or ``k2 % nb``.

    Returns (bucket [n], slot [n]) or None when placement fails. Three
    passes: greedy into the primary bucket, spill into the second choice's
    free slots, then cuckoo random-walk eviction for the residue."""
    n = len(k1)
    b1 = (k1 % np.uint32(nb)).astype(np.int64)
    b2 = (k2 % np.uint32(nb)).astype(np.int64)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z
    # pass 1: primary bucket, first `slots` keys per bucket
    counts1 = np.bincount(b1, minlength=nb)
    order = np.argsort(b1, kind="stable")
    first = np.zeros(nb, np.int64)
    np.cumsum(counts1[:-1], out=first[1:])
    rank = np.arange(n, dtype=np.int64) - first[b1[order]]
    primary = rank < slots
    out_bucket = np.full(n, -1, np.int64)
    out_slot = np.full(n, -1, np.int64)
    p_idx = order[primary]
    out_bucket[p_idx] = b1[p_idx]
    out_slot[p_idx] = rank[primary]
    # pass 2: overflow into the second choice's free slots
    o_idx = order[~primary]
    if len(o_idx):
        ob2 = b2[o_idx]
        taken = np.minimum(counts1, slots)
        oorder = np.argsort(ob2, kind="stable")
        counts2 = np.bincount(ob2, minlength=nb)
        first2 = np.zeros(nb, np.int64)
        np.cumsum(counts2[:-1], out=first2[1:])
        rank2 = np.arange(len(o_idx), dtype=np.int64) - first2[ob2[oorder]]
        fits = rank2 < (slots - taken[ob2[oorder]])
        f_idx = o_idx[oorder][fits]
        out_bucket[f_idx] = ob2[oorder][fits]
        out_slot[f_idx] = taken[ob2[oorder][fits]] + rank2[fits]
        residue = o_idx[oorder][~fits]
    else:
        residue = o_idx
    if len(residue):
        # pass 3: cuckoo eviction walks over an explicit occupancy table
        table = np.full((nb, slots), -1, np.int32)
        ok = out_bucket >= 0
        table[out_bucket[ok], out_slot[ok]] = np.nonzero(ok)[0]
        rng = np.random.RandomState(0x5EED)
        for start in residue:
            cur = int(start)
            b = int(b1[cur]) if rng.rand() < 0.5 else int(b2[cur])
            for _step in range(500):
                row = table[b]
                free = np.nonzero(row < 0)[0]
                if len(free):
                    table[b, free[0]] = cur
                    break
                s = int(rng.randint(slots))
                victim = int(row[s])
                table[b, s] = cur
                cur = victim
                b = int(b2[cur]) if b == int(b1[cur]) else int(b1[cur])
            else:
                return None  # the walk did not converge; the caller grows nb
        occ = table >= 0
        bkt, slt = np.nonzero(occ)
        out_bucket[table[bkt, slt]] = bkt
        out_slot[table[bkt, slt]] = slt
    return out_bucket, out_slot


def _probe(
    keys: torch.Tensor,
    vals: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    two_choice: bool = False,
):
    """Probe a split bucket table: (found [...], value rows [..., nv]
    int32). ``k1``/``k2`` are u32 in int64; a ``two_choice`` table adds
    the second bucket's key row."""
    nb, slots = keys.shape[0], keys.shape[1]
    b1 = k1 % nb
    rows = keys[b1]  # [..., slots, 2]
    i1, i2 = _as_i32(k1), _as_i32(k2)
    if two_choice:
        b2 = k2 % nb
        rows = torch.cat([rows, keys[b2]], dim=-2)  # [..., 2 slots, 2]
    hit = (rows[..., 0] == i1[..., None]) & (rows[..., 1] == i2[..., None])
    found = hit.any(dim=-1)
    slot = hit.to(torch.int32).argmax(dim=-1).long()  # the first hit
    if two_choice:
        bucket = torch.where(slot < slots, b1, b2)
        return found, vals[bucket, slot % slots]
    return found, vals[b1, slot]


def _as_f32(v: torch.Tensor) -> torch.Tensor:
    return v.view(torch.float32)


# -- the LM: ARPA text or KenLM binary -> tables -------------------------------


def _parse_arpa(path: str):
    """Minimal ARPA reader (independent of the C++ one in beam_search.cpp).

    Returns (order, word_ids {str: int}, entries [order] of
    (ids [N, n] int32, prob [N] f32, backoff [N] f32)).
    """
    word_ids: dict[str, int] = {}
    grams: list[list[tuple[list[int], float, float]]] = []
    order = 0
    current = 0
    with open(path, errors="replace") as f:
        for line in f:
            line = line.rstrip("\r\n")
            if line.startswith("\\") and line.endswith("-grams:"):
                current = int(line[1 : line.index("-")])
                order = max(order, current)
                while len(grams) < current:
                    grams.append([])
                continue
            if line == "\\end\\":
                break
            if current == 0 or not line:
                continue
            parts = line.split()
            if len(parts) < current + 1:
                continue
            try:
                prob = float(parts[0])
            except ValueError:
                continue
            words = parts[1 : 1 + current]
            backoff = 0.0
            if len(parts) > current + 1:
                try:
                    backoff = float(parts[current + 1])
                except ValueError:
                    backoff = 0.0
            ids = []
            for w in words:
                if w not in word_ids:
                    word_ids[w] = len(word_ids)
                ids.append(word_ids[w])
            grams[current - 1].append((ids, prob, backoff))
    entries = []
    for n, rows in enumerate(grams, start=1):
        if rows:
            ids = np.array([r[0] for r in rows], np.int32)
            prob = np.array([r[1] for r in rows], np.float32)
            back = np.array([r[2] for r in rows], np.float32)
        else:
            ids = np.zeros((0, n), np.int32)
            prob = np.zeros((0,), np.float32)
            back = np.zeros((0,), np.float32)
        entries.append((ids, prob, back))
    return order, word_ids, entries


def _word_char_ids(word: str) -> list[int] | None:
    """Char ids of a word, or None if it leaves the decoder alphabet."""
    ids = []
    for ch in word:
        if ch == "'":
            ids.append(vocabulary.APOSTROPHE_ID)
        elif "a" <= ch <= "z":
            ids.append(ord(ch) - ord("a"))
        else:
            return None
    return ids


def _trie_words_from(vocab_path: str | None, word_ids) -> set[str]:
    """Valid-word set: the vocabulary file, else the LM's own words
    (lowercased), less the specials: the host trie's content."""
    trie_words: set[str] = set()
    if vocab_path:
        with open(vocab_path, errors="replace") as vf:
            for w in vf:
                w = w.strip().lower()
                if w:
                    trie_words.add(w)
    else:
        for w in word_ids:
            if w in ("<s>", "</s>", "<unk>"):
                continue
            trie_words.add(w.lower())
    return trie_words


def _build_word_tables(word_ids: dict[str, int], trie_words: set[str],
                       unk_id: int):
    """Word table: rolling char hash -> (LM word id, valid-word bit), over
    every alphabet-representable word either side knows."""
    keys: dict[tuple[int, int], tuple[int, int]] = {}
    for w in set(word_ids) | trie_words:
        cids = _word_char_ids(w)
        if cids is None or not cids:
            continue
        wh = _np_word_hash(np.array(cids, np.int64))
        wid = word_ids.get(w, unk_id)
        valid = 1 if w in trie_words else 0
        keys[(int(wh[0]), int(wh[1]))] = (wid, valid)
    wk1 = np.array([k[0] for k in keys], np.uint32).reshape(-1)
    wk2 = np.array([k[1] for k in keys], np.uint32).reshape(-1)
    wid_arr = np.array([v[0] for v in keys.values()], np.int32)
    val_arr = np.array([v[1] for v in keys.values()], np.int32)
    return _build_bucket_table(wk1, wk2, [wid_arr, val_arr])


def _assemble_arena(k1s, k2s, probs, backs):
    """One bucketed table over all orders >= 2."""
    if k1s:
        k1 = np.concatenate(k1s)
        k2 = np.concatenate(k2s)
        prob = np.concatenate(probs)
        back = np.concatenate(backs)
    else:
        k1 = np.zeros(0, np.uint32)
        k2 = np.zeros(0, np.uint32)
        prob = back = np.zeros(0, np.float32)
    return _build_bucket_table(k1, k2, [prob, back])


class DeviceLMBudgetError(Exception):
    """The LM tables exceed the device-memory budget; raised before any
    copy to the device. Carries ``bytes_needed`` so callers can print the
    figure when they fall back to the host beam."""

    def __init__(self, bytes_needed: int, budget_bytes: int):
        self.bytes_needed = bytes_needed
        self.budget_bytes = budget_bytes
        super().__init__(
            f"device LM tables need {bytes_needed / (1 << 30):.2f} GiB "
            f"HBM > budget {budget_bytes / (1 << 30):.2f} GiB"
        )


def _upload_tables(
    np_tables: dict, hbm_budget_bytes: int | None, device
) -> dict:
    """Budget-check the host arrays, then copy them to ``device``. The
    check comes first, so an LM that does not fit never touches the card."""
    total = sum(int(a.size) * 4 for a in np_tables.values())
    if hbm_budget_bytes is not None and total > hbm_budget_bytes:
        raise DeviceLMBudgetError(total, hbm_budget_bytes)
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in np_tables.items()
    }


class DeviceLM:
    """Backoff n-gram LM as hash tables in device memory.

    - ``DeviceLM(arpa_path, vocab_path, device=...)`` parses KenLM's ARPA
      text; n-gram windows are keyed by this module's FNV-style dual
      32-bit hash over interned word ids.
    - ``DeviceLM.from_binary(binary_path, vocab_path, device=...)`` reads a
      KenLM PROBING binary through ``native.kenlm_dump``; its keys are
      KenLM's own chained 64-bit hashes, which the search recomputes from
      its word-id history.
    - ``DeviceLM.cached(model_path, ...)`` takes either and keeps the
      packed tables on disk.

    Scoring mirrors the host scorers (same backoff walk, <unk> floor and
    valid-word set). ``tables`` holds int32 tensors on ``device``:
    ``uni`` [V, 3], ``arena_k``/``arena_v`` [NB, 4, 2] and
    ``words_k``/``words_v`` [NBw, 4, 2].
    """

    def __init__(
        self,
        arpa_path: str,
        vocab_path: str | None = None,
        hbm_budget_bytes: int | None = None,
        device="cpu",
    ):
        meta, np_tables = _build_np_from_arpa(arpa_path, vocab_path)
        other = type(self)._from_np(meta, np_tables, hbm_budget_bytes, device)
        self.__dict__.update(other.__dict__)

    @classmethod
    def from_binary(
        cls,
        binary_path: str,
        vocab_path: str | None = None,
        hbm_budget_bytes: int | None = None,
        device="cpu",
    ):
        meta, np_tables = _build_np_from_binary(binary_path, vocab_path)
        return cls._from_np(meta, np_tables, hbm_budget_bytes, device)

    @classmethod
    def cached(
        cls,
        model_path: str,
        vocab_path: str | None = None,
        hbm_budget_bytes: int | None = None,
        cache_dir: str | None = None,
        device="cpu",
    ):
        """Build from ARPA or PROBING binary, keeping the packed tables.

        The finished numpy tables are keyed on the content of the LM file,
        the vocabulary and the packing format and stored as one npz in
        ``cache_dir`` (``$SPEECHT_DEVICE_LM_CACHE``, default
        ``~/.cache/speecht_tpu_torch/device_lm``); a later process loads
        them and goes straight to the copy to the device. A changed file
        hashes to a new key.
        """
        meta, np_tables = _cached_np_tables(model_path, vocab_path, cache_dir)
        return cls._from_np(meta, np_tables, hbm_budget_bytes, device)

    @classmethod
    def _from_np(cls, meta: dict, np_tables: dict,
                 hbm_budget_bytes: int | None, device):
        self = cls.__new__(cls)
        self.order = int(meta["order"])
        self.hist_len = int(meta["hist_len"])
        self.key_scheme = str(meta["key_scheme"])
        self.unk_id = int(meta["unk_id"])
        self.bos_id = int(meta["bos_id"])
        self.unk_floor = float(meta["unk_floor"])
        self.arena_two_choice = bool(meta["arena_two_choice"])
        self.words_two_choice = bool(meta["words_two_choice"])
        self.tables = _upload_tables(np_tables, hbm_budget_bytes, device)
        return self

    def hbm_bytes(self) -> int:
        """Device memory the LM tables occupy."""
        return sum(t.numel() * 4 for t in self.tables.values())


def _pack_tables(
    order: int,
    key_scheme: str,
    word_ids: dict,
    unk_id: int,
    unk_floor: float,
    uni,
    k1s,
    k2s,
    probs,
    backs,
    vocab_path: str | None,
) -> tuple[dict, dict]:
    """The packing both builders share: arena, word tables and the meta
    dict. _META_KEYS and the npz cache follow the meta layout made here."""
    ak, av, a2c = _assemble_arena(k1s, k2s, probs, backs)
    trie_words = _trie_words_from(vocab_path, word_ids)
    wk, wv, w2c = _build_word_tables(word_ids, trie_words, unk_id)
    meta = {
        "order": order,
        # host semantics: context capped at <s> + 4 completed words
        "hist_len": min(order - 1, 5),
        "key_scheme": key_scheme,
        "unk_id": unk_id,
        "bos_id": word_ids.get("<s>", -1),
        "unk_floor": unk_floor,
        "arena_two_choice": a2c,
        "words_two_choice": w2c,
    }
    return meta, {
        "uni": uni, "arena_k": ak, "arena_v": av,
        "words_k": wk, "words_v": wv,
    }


def _build_np_from_binary(
    binary_path: str, vocab_path: str | None
) -> tuple[dict, dict]:
    """Host table build from a KenLM PROBING binary."""
    from speecht_tpu_torch import native

    d = native.kenlm_dump(binary_path)
    order = d["order"]
    words = d["words"]
    word_ids = {w: i for i, w in enumerate(words)}
    unk_id = word_ids.get("<unk>", 0)

    uprob = np.asarray(d["uni_prob"], np.float32)
    uback = np.asarray(d["uni_back"], np.float32)
    unk_floor = float(uprob[unk_id]) if len(uprob) else -10.0
    # the host binary scorer finds every id of the unigram array (a
    # missing entry reads as prob 0.0): mirror it
    upresent = np.ones(max(len(uprob), 1), np.int32)
    uni = np.stack(
        [
            uprob.view(np.int32) if len(uprob) else np.zeros(1, np.int32),
            uback.view(np.int32) if len(uback) else np.zeros(1, np.int32),
            upresent,
        ],
        axis=-1,
    )
    k1s, k2s, probs, backs = [], [], [], []
    for n in range(2, order + 1):
        lo, hi, prob, back = d["tables"][n]
        k1s.append(lo)
        k2s.append(hi)
        probs.append(prob)
        backs.append(back)
    return _pack_tables(
        order, "kenlm", word_ids, unk_id, unk_floor, uni,
        k1s, k2s, probs, backs, vocab_path,
    )


def _build_np_from_arpa(
    arpa_path: str, vocab_path: str | None
) -> tuple[dict, dict]:
    """Host table build from ARPA text."""
    order, word_ids, entries = _parse_arpa(arpa_path)
    if order == 0:
        raise ValueError(f"no n-grams parsed from {arpa_path}")

    unk_id = word_ids.get("<unk>", len(word_ids))
    unk_floor = -10.0
    uni_ids, uni_prob, uni_back = entries[0]

    # unigrams: direct-indexed arrays over the interned id space
    nwords = len(word_ids)
    uprob = np.zeros(max(nwords, 1), np.float32)
    uback = np.zeros(max(nwords, 1), np.float32)
    upresent = np.zeros(max(nwords, 1), bool)
    for row, p, b in zip(uni_ids[:, 0], uni_prob, uni_back):
        uprob[row] = p
        uback[row] = b
        upresent[row] = True
    if unk_id < nwords and upresent[unk_id]:
        unk_floor = float(uprob[unk_id])

    # one 12-byte row per unigram lookup (prob, backoff, present)
    uni = np.stack(
        [
            uprob.view(np.int32),
            uback.view(np.int32),
            upresent.astype(np.int32),
        ],
        axis=-1,
    )
    # all orders 2..order in one arena (the key hash depends on the
    # sequence's length, so orders cannot collide but by 64-bit accident)
    k1s, k2s, probs, backs = [], [], [], []
    for n in range(2, order + 1):
        ids, prob, back = entries[n - 1]
        k1, k2 = _np_key_hash_rows(ids)
        k1s.append(k1)
        k2s.append(k2)
        probs.append(prob)
        backs.append(back)
    return _pack_tables(
        order, "fnv", word_ids, unk_id, unk_floor, uni,
        k1s, k2s, probs, backs, vocab_path,
    )


# bump when the packed-table layout or key hashing changes: stale cache
# entries must miss, not load
_LM_CACHE_FORMAT = 1

_META_KEYS = (
    "order", "hist_len", "key_scheme", "unk_id", "bos_id", "unk_floor",
    "arena_two_choice", "words_two_choice",
)
_TABLE_KEYS = ("uni", "arena_k", "arena_v", "words_k", "words_v")


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _lm_cache_key(model_path: str, vocab_path: str | None) -> str:
    h = hashlib.sha256()
    h.update(f"format={_LM_CACHE_FORMAT}\n".encode())
    h.update(f"model={_file_sha256(model_path)}\n".encode())
    if vocab_path:
        h.update(f"vocab={_file_sha256(vocab_path)}\n".encode())
    return h.hexdigest()[:24]


def _evict_lm_cache(cache_dir: str, keep_path: str, max_bytes: int):
    """Drop least-recently-used cache entries until the directory fits
    ``max_bytes``; the entry just written stays."""
    entries = []
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return
    for name in names:
        if not (name.startswith("lm-") and name.endswith(".npz")):
            continue
        p = os.path.join(cache_dir, name)
        try:
            st = os.stat(p)
        except OSError:
            continue
        entries.append((st.st_mtime, st.st_size, p))
    total = sum(size for _, size, _ in entries)
    for _, size, p in sorted(entries):  # oldest mtime first
        if total <= max_bytes:
            return
        if p == keep_path:
            continue
        try:
            os.remove(p)
            total -= size
        except OSError:
            pass  # concurrent eviction or permissions: best effort


def _cached_np_tables(
    model_path: str, vocab_path: str | None, cache_dir: str | None
) -> tuple[dict, dict]:
    cache_dir = cache_dir or os.environ.get(
        "SPEECHT_DEVICE_LM_CACHE",
        os.path.expanduser("~/.cache/speecht_tpu_torch/device_lm"),
    )
    path = os.path.join(
        cache_dir, f"lm-{_lm_cache_key(model_path, vocab_path)}.npz"
    )
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            meta = {k: z[f"meta_{k}"][()] for k in _META_KEYS}
            np_tables = {k: z[k] for k in _TABLE_KEYS}
        try:
            os.utime(path)  # mark recently used for the LRU eviction
        except OSError:
            pass
        return meta, np_tables

    from speecht_tpu_torch import native

    if native.lm_is_binary(model_path):
        meta, np_tables = _build_np_from_binary(model_path, vocab_path)
    else:
        meta, np_tables = _build_np_from_arpa(model_path, vocab_path)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp.npz"  # .npz suffix: savez keeps it
    payload = dict(np_tables)
    for k in _META_KEYS:
        payload[f"meta_{k}"] = np.asarray(meta[k])
    np.savez(tmp, **payload)
    # atomic publish: a concurrent process never sees a torn npz
    os.replace(tmp, path)
    _evict_lm_cache(
        cache_dir,
        keep_path=path,
        max_bytes=int(
            os.environ.get("SPEECHT_DEVICE_LM_CACHE_MAX_BYTES", 4 << 30)
        ),
    )
    return meta, np_tables


# -- the plain search ------------------------------------------------------------


def _make_lm_fns(lm: DeviceLM | None):
    """(word_lookup, ngram_score) over the LM's tables, or (None, None).

    word_lookup(wh1, wh2) -> (wid [.] int64, valid [.] float32)
    ngram_score(hist [., H] int64, hcnt [.], wid [.]) -> log10 prob, f32
    Both are pure table gathers, computed for every beam and masked.
    """
    if lm is None:
        return None, None
    H = lm.hist_len
    t = lm.tables
    nuni = t["uni"].shape[0]
    window_hash = _kenlm_key_hash if lm.key_scheme == "kenlm" else _key_hash

    def word_lookup(wh1, wh2):
        found, v = _probe(
            t["words_k"], t["words_v"], wh1, wh2, lm.words_two_choice
        )
        wid = torch.where(found, v[..., 0].long(), lm.unk_id)
        valid = torch.where(found, v[..., 1], 0).to(torch.float32)
        return wid, valid

    def uni_lookup(wid):
        inb = (wid >= 0) & (wid < nuni)
        row = t["uni"][wid.clamp(0, nuni - 1)]  # [., 3]
        found = inb & (row[..., 2] > 0)
        return found, _as_f32(row[..., 0]), _as_f32(row[..., 1])

    def ngram_score(hist, hcnt, wid):
        """log10 P(wid | hist) with Katz backoff, the host score() twin.

        ``hist`` [., H] holds the most recent tokens last (<s> included),
        ``hcnt`` how many of them are real. Unrolled over n with masks per
        row; every bucket key of the walk goes through one arena probe.
        """
        tok = torch.cat([hist, wid[..., None]], dim=-1)  # [., H+1]
        ctx = hcnt.clamp(max=H)
        # bucket keys: the n-grams (n = H+1..2), then the backoff contexts
        # (length H..2); the unigram levels are direct-indexed
        windows = [tok[..., H + 1 - n :] for n in range(H + 1, 1, -1)]
        bwindows = [tok[..., H + 1 - n : H] for n in range(H + 1, 2, -1)]
        allw = windows + bwindows
        if allw:
            keys = [window_hash(w) for w in allw]
            found_l, v_l = _probe(
                t["arena_k"], t["arena_v"],
                torch.stack([k[0] for k in keys], dim=-1),
                torch.stack([k[1] for k in keys], dim=-1),
                lm.arena_two_choice,
            )
            prob_l = _as_f32(v_l[..., 0])
            back_l = _as_f32(v_l[..., 1])

        def level(n):
            """(found, prob) of the n-gram ending at the word."""
            if n == 1:
                found, prob, _ = uni_lookup(tok[..., H])
                return found, prob
            i = (H + 1) - n  # position in `windows`
            return found_l[..., i], prob_l[..., i]

        def blevel(n):
            """(found, backoff) of the length-n context before the word."""
            if n == 1:
                found, _, back = uni_lookup(tok[..., H - 1])
                return found, back
            i = len(windows) + (H + 1) - (n + 1)  # position in `bwindows`
            return found_l[..., i], back_l[..., i]

        res = torch.zeros(wid.shape, dtype=torch.float32, device=wid.device)
        bsum = torch.zeros_like(res)
        done = torch.zeros(wid.shape, dtype=torch.bool, device=wid.device)
        for n in range(H + 1, 0, -1):
            applicable = n <= ctx + 1
            found, prob = level(n)
            take = (~done) & applicable & found
            res = torch.where(take, prob + bsum, res)
            done = done | (applicable & found)
            if n > 1:
                bfound, bback = blevel(n - 1)
                bsum = bsum + torch.where((~done) & applicable & bfound, bback, 0.0)
        return torch.where(done, res, lm.unk_floor + bsum)

    return word_lookup, ngram_score


# packed beam-state column layout: per frame the U/I slabs are reindexed
# by one gather each; the F slab is rebuilt from the selected candidates
_F_PB, _F_PNB, _F_LM = 0, 1, 2  # f32 slab [B, W, 3]
_U_H1, _U_H2, _U_PH1, _U_PH2, _U_WH1, _U_WH2 = range(6)  # u32 slab [B, W, 6]
_I_LAST, _I_WLEN, _I_HCNT, _I_ALIVE = range(4)  # int slab [B, W, 4 + H]


class BeamSpec:
    """What a search is built for: the width, the emission pruning, the
    n-best count and the LM's shape (history length, ``<s>`` handling)."""

    def __init__(self, beam_width: int, lm: DeviceLM | None, prune_top_k: int,
                 n_best: int):
        if beam_width < 1:
            raise ValueError(f"beam_width must be at least 1, got {beam_width}")
        if not 1 <= n_best <= beam_width:
            raise ValueError("n_best must be in [1, beam_width]")
        self.W = beam_width
        self.lm = lm
        self.prune_top_k = prune_top_k
        self.n_best = n_best
        self.H = lm.hist_len if lm is not None else 1
        self.bos_id = lm.bos_id if lm is not None else -1
        # host history semantics (beam_search.cpp): <s> is pinned and the
        # word ring holds at most 4 completed words. For H <= 4 a sliding
        # window over the bos + words stream is the same; at H == 5 (order
        # >= 6) the <s> slot must not shift out, and without <s> the real
        # token count caps at 4 so padding never enters an applicable window
        self.pin_bos = self.H == 5 and self.bos_id >= 0
        self.hcnt_cap = self.H if self.bos_id >= 0 else min(self.H, 4)

    def top_k(self, C: int) -> int:
        return self.prune_top_k if 0 < self.prune_top_k < C else C


def fusion_weights(lm_weight, word_count_weight, valid_word_count_weight):
    """The weights as the float32 values the search uses: (lm_weight *
    ln 10 rounded to float32, word_count_weight, valid_word_count_weight),
    each a Python float that holds a float32 value exactly."""
    lm_w = np.float32(lm_weight)
    return (
        float(np.float32(lm_w * np.float32(_LN10))),
        float(np.float32(word_count_weight)),
        float(np.float32(valid_word_count_weight)),
    )


def _sort_desc(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, ties to the lower
    index (a stable descending sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.inference_mode()
def plain_beam_search(spec: BeamSpec, logp: torch.Tensor, lengths: torch.Tensor,
                      lm_weight, word_count_weight, valid_word_count_weight):
    """The search in torch ops on ``logp``'s device, the rows as a batch
    dimension (JAX's ``lax.scan`` under ``vmap``). See
    :func:`make_device_beam_search` for the arguments and outputs."""
    lm_ln10, wc_w, vwc_w = fusion_weights(
        lm_weight, word_count_weight, valid_word_count_weight
    )
    word_lookup, ngram_score = _make_lm_fns(spec.lm)
    W, H, n_best = spec.W, spec.H, spec.n_best
    dev = logp.device
    logp = logp.to(torch.float32)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    B, T, C = logp.shape
    K = spec.top_k(C)
    f32, i64 = torch.float32, torch.int64

    def space_bonus(wh1, wh2, wlen, hist, hcnt):
        """(fusion bonus of completing the partial word, its word id);
        the bonus only where ``wlen > 0``."""
        if spec.lm is None:
            return (
                torch.where(wlen > 0, wc_w, 0.0).to(f32),
                torch.zeros_like(wlen),
            )
        wid, valid = word_lookup(wh1, wh2)
        sc = ngram_score(hist, hcnt, wid)
        bonus = wc_w + vwc_w * valid + lm_ln10 * sc
        return torch.where(wlen > 0, bonus, 0.0), wid

    F = torch.zeros(B, W, 3, dtype=f32, device=dev)
    F[..., _F_PB] = NEG
    F[:, 0, _F_PB] = 0.0
    F[..., _F_PNB] = NEG
    U = torch.zeros(B, W, 6, dtype=i64, device=dev)
    U[..., _U_H1], U[..., _U_H2] = _SEED1, _SEED2
    U[..., _U_WH1], U[..., _U_WH2] = _WSEED1, _WSEED2
    I = torch.zeros(B, W, 4 + H, dtype=i64, device=dev)
    I[..., _I_LAST] = -1
    I[:, 0, _I_ALIVE] = 1
    if spec.bos_id >= 0 and H > 0:
        I[..., 4 + H - 1] = spec.bos_id
        I[..., _I_HCNT] = 1

    bp_par = torch.empty(B, T, W, dtype=i64, device=dev)
    bp_ch = torch.empty(B, T, W, dtype=i64, device=dev)
    slots = torch.arange(W, device=dev).expand(B, W)
    rows_b = torch.arange(B, device=dev)[:, None].expand(B, W)
    all_chars = torch.arange(C, device=dev).expand(B, C)
    neg_row = torch.full((B, 1, K), NEG, dtype=f32, device=dev)
    for t in range(T):
        lp = logp[:, t]  # [B, C]
        pb, pnb, lm_sc = F.unbind(-1)
        h1, h2 = U[..., _U_H1], U[..., _U_H2]
        ph1, ph2 = U[..., _U_PH1], U[..., _U_PH2]
        wh1, wh2 = U[..., _U_WH1], U[..., _U_WH2]
        last, wlen = I[..., _I_LAST], I[..., _I_WLEN]
        hcnt, alive = I[..., _I_HCNT], I[..., _I_ALIVE] > 0
        hist = I[..., 4:]

        # host parity: per-frame emission pruning to the top-K chars (the
        # blank is always considered for the stay path)
        if K < C:
            topv, topi = _sort_desc(lp, K)
        else:
            topv, topi = lp, all_chars
        ptot = torch.logaddexp(pb, pnb)
        blank_lp = lp[:, _BLANK, None]
        lp_last = lp.gather(1, last.clamp(min=0))

        # stay candidates (prefix unchanged)
        last_in = topi[:, None, :] == last[..., None]  # [B, W, K]
        last_ok = last_in.any(dim=-1) & (last >= 0)
        stay_pb = ptot + blank_lp
        stay_pnb = torch.where(last_ok, pnb + lp_last, NEG)

        # extend candidates [B, W, K] (blank slots masked)
        base = torch.where(last_in, pb[..., None], ptot[..., None])
        ext_pnb = base + topv[:, None, :]
        ext_pnb = torch.where((topi == _BLANK)[:, None, :], NEG, ext_pnb)

        # fusion bonus of completing this beam's partial word [B, W]
        bonus, wid = space_bonus(wh1, wh2, wlen, hist, hcnt)
        ext_lm = lm_sc[..., None] + torch.where(
            (topi[:, None, :] == _SPACE) & (wlen[..., None] > 0),
            bonus[..., None],
            0.0,
        )

        # merge: stay(j) == extend(p, last[j]), the only duplicate a CTC
        # prefix beam search makes; row W of the [W+1, K] buffers takes
        # the writes of the beams without a match
        match = (
            (h1[:, None, :] == ph1[..., None])
            & (h2[:, None, :] == ph2[..., None])
            & alive[:, None, :]
            & alive[..., None]
            & (last[..., None] >= 0)
            & last_ok[..., None]
        )  # [B, j, p]
        has = match.any(dim=-1)
        p_idx = match.to(torch.int32).argmax(dim=-1)  # the first match
        k_idx = last_in.to(torch.int32).argmax(dim=-1).long()
        rows = torch.where(has, p_idx.long(), W)
        prev = ext_pnb[rows_b, rows.clamp(max=W - 1), k_idx]
        # only a match merges (row W's writes are dropped)
        merged = torch.logaddexp(torch.where(has, prev, NEG), stay_pnb)
        ext_pnb = torch.cat([ext_pnb, neg_row], dim=1)
        ext_pnb[rows_b, rows, k_idx] = merged
        ext_pnb = ext_pnb[:, :W]
        ext_pb = torch.full((B, W + 1, K), NEG, dtype=f32, device=dev)
        ext_pb[rows_b, rows, k_idx] = stay_pb
        ext_pb = ext_pb[:, :W]
        stay_pb = torch.where(has, NEG, stay_pb)
        stay_pnb = torch.where(has, NEG, stay_pnb)

        # the pool [(K+1)·W] and its top W
        cand_pb = torch.cat([stay_pb, ext_pb.reshape(B, W * K)], dim=1)
        cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(B, W * K)], dim=1)
        cand_lm = torch.cat([lm_sc, ext_lm.reshape(B, W * K)], dim=1)
        ext_ch = topi[:, None, :].expand(B, W, K).reshape(B, W * K)
        cand_alive = torch.cat([alive, alive.repeat_interleave(K, dim=1)], dim=1)
        total = torch.logaddexp(cand_pb, cand_pnb) + cand_lm
        total = torch.where(cand_alive, total, NEG)

        tv, idx = _sort_desc(total, W)
        is_stay = idx < W
        par = torch.where(is_stay, idx, torch.div(idx - W, K, rounding_mode="floor"))
        ch = torch.where(is_stay, -1, ext_ch.gather(1, (idx - W).clamp(min=0)))
        u = ch.clamp(min=0) + 2

        # reindex the int slabs; the f32 slab is rebuilt from the pool
        Up = U.gather(1, par[..., None].expand(B, W, 6))
        Ip = I.gather(1, par[..., None].expand(B, W, 4 + H))
        n_h1 = torch.where(is_stay, Up[..., _U_H1],
                           (_mul32(Up[..., _U_H1], _M1) + u) & _MASK32)
        n_h2 = torch.where(is_stay, Up[..., _U_H2],
                           (_mul32(Up[..., _U_H2], _M2) + u) & _MASK32)
        n_ph1 = torch.where(is_stay, Up[..., _U_PH1], Up[..., _U_H1])
        n_ph2 = torch.where(is_stay, Up[..., _U_PH2], Up[..., _U_H2])
        is_space = (~is_stay) & (ch == _SPACE)
        completes = is_space & (Ip[..., _I_WLEN] > 0)
        n_wh1 = torch.where(is_stay, Up[..., _U_WH1], torch.where(
            is_space, _WSEED1, (_mul32(Up[..., _U_WH1], _M1) + u) & _MASK32))
        n_wh2 = torch.where(is_stay, Up[..., _U_WH2], torch.where(
            is_space, _WSEED2, (_mul32(Up[..., _U_WH2], _M2) + u) & _MASK32))
        n_last = torch.where(is_stay, Ip[..., _I_LAST], ch)
        n_wlen = torch.where(is_stay, Ip[..., _I_WLEN], torch.where(
            is_space, 0, Ip[..., _I_WLEN] + 1))
        n_hcnt = torch.where(completes, (Ip[..., _I_HCNT] + 1).clamp(
            max=spec.hcnt_cap), Ip[..., _I_HCNT])
        n_alive = (tv > NEG / 2).to(i64)
        if H > 0:
            wid_col = wid.gather(1, par)[..., None]
            shifted = torch.cat([Ip[..., 5:], wid_col], dim=-1)
            if spec.pin_bos:
                # <s> is pinned once it reaches slot 0: while the ring
                # fills (hcnt < cap) the plain shift slides it leftward;
                # then the pinned shift keeps slot 0 and rotates the rest
                pinned = torch.cat([Ip[..., 4:5], Ip[..., 6:], wid_col], dim=-1)
                ring_full = (Ip[..., _I_HCNT] == spec.hcnt_cap)[..., None]
                shifted = torch.where(ring_full, pinned, shifted)
            n_hist = torch.where(completes[..., None], shifted, Ip[..., 4:])
        else:  # unigram-only LM: no history to shift
            n_hist = Ip[..., 4:]

        nF = torch.stack(
            [cand_pb.gather(1, idx), cand_pnb.gather(1, idx), cand_lm.gather(1, idx)],
            dim=-1,
        )
        nU = torch.stack([n_h1, n_h2, n_ph1, n_ph2, n_wh1, n_wh2], dim=-1)
        nI = torch.cat(
            [torch.stack([n_last, n_wlen, n_hcnt, n_alive], dim=-1), n_hist], dim=-1
        )

        # frames past a row's length leave its beam untouched
        upd = (t < lengths)[:, None]
        F = torch.where(upd[..., None], nF, F)
        U = torch.where(upd[..., None], nU, U)
        I = torch.where(upd[..., None], nI, I)
        bp_par[:, t] = torch.where(upd, par, slots)
        bp_ch[:, t] = torch.where(upd, ch, -1)

    # final ranking: the trailing partial word also scores as a word (the
    # host beam's sentence-end handling)
    fbonus, _ = space_bonus(
        U[..., _U_WH1], U[..., _U_WH2], I[..., _I_WLEN], I[..., 4:], I[..., _I_HCNT]
    )
    final = torch.logaddexp(F[..., _F_PB], F[..., _F_PNB]) + F[..., _F_LM] + fbonus
    final = torch.where(I[..., _I_ALIVE] > 0, final, NEG)
    scores, cur = _sort_desc(final, n_best)  # [B, n]

    # backtrack the backpointer lattice, then compact the kept chars
    seq = torch.empty(B, n_best, T, dtype=i64, device=dev)
    for t in range(T - 1, -1, -1):
        seq[:, :, t] = bp_ch[:, t].gather(1, cur)
        cur = bp_par[:, t].gather(1, cur)
    keep = seq >= 0
    pos = torch.where(keep, keep.cumsum(dim=-1) - 1, T)
    out = torch.full((B, n_best, T + 1), vocabulary.PAD_ID, dtype=i64, device=dev)
    out.scatter_(2, pos, seq)
    ids = out[..., :T].to(torch.int32)
    lens = keep.sum(dim=-1).to(torch.int32)
    if n_best == 1:
        return ids[:, 0], lens[:, 0]
    return ids, lens, scores


def make_device_beam_search(
    beam_width: int,
    lm: DeviceLM | None = None,
    prune_top_k: int = 8,
    n_best: int = 1,
):
    """Builds the batch beam search.

    Returns ``fn(logp, lengths, lm_weight, word_count_weight,
    valid_word_count_weight) -> (ids [B, T] int32 padded PAD_ID,
    lengths [B] int32)`` on ``logp``'s device, where ``logp`` is [B, T, C]
    float32 natural-log emissions (typically blank-collapsed) and
    ``lengths`` [B] the frames of each row. The three weights are plain
    call arguments, so ``search`` reruns candidates on the same tables and
    emissions. ``prune_top_k`` mirrors the host beam's per-frame emission
    pruning (only the frame's top-k chars spawn extensions; 0 takes
    every char). ``n_best > 1`` returns the n best final hypotheses per
    row: ``(ids [B, n, T], lengths [B, n], scores [B, n])``, scores
    descending (ln acoustic + fused LM, the sentence-end word bonus
    included).

    Log-probs on the CPU take :func:`plain_beam_search`; on a CUDA device
    ``csrc/beam_device.cu`` (raising if it cannot launch). The LM's tables
    must lie on ``logp``'s device. ``fn.plain`` is the plain version on
    any device, ``fn.spec`` the :class:`BeamSpec`.
    """
    spec = BeamSpec(beam_width, lm, prune_top_k, n_best)

    def fn(logp, lengths, lm_weight, word_count_weight, valid_word_count_weight):
        if logp.device.type == "cpu":
            return plain_beam_search(spec, logp, lengths, lm_weight,
                                     word_count_weight, valid_word_count_weight)
        from speecht_tpu_torch.ops import beam_device_cuda

        return beam_device_cuda.BEAM_DEVICE(
            spec, logp, lengths, lm_weight, word_count_weight,
            valid_word_count_weight,
        )

    def plain(logp, lengths, lm_weight, word_count_weight, valid_word_count_weight):
        return plain_beam_search(spec, logp, lengths, lm_weight,
                                 word_count_weight, valid_word_count_weight)

    fn.plain = plain
    fn.spec = spec
    return fn

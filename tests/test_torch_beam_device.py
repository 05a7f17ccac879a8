"""The port's device beam (``ops/beam_device.py``) against the JAX
package's, on the CPU.

The same inputs, made from numpy seeds, go through JAX's
``make_device_beam_search`` and the port's (its plain version: the
log-probs lie on the CPU), and through the port's host C++ beam:

- the LM tables: every array and meta field the port builds from the
  tiny ARPA of ``test_beam_device.py``, an order-6 ARPA, an order-1 ARPA,
  a seeded ARPA of about 10^4 n-grams that needs two-choice placement and
  a KenLM binary written by the JAX package, bit-equal to JAX's; the
  port's ``native.kenlm_dump`` equal to JAX's field by field;
- the hashes: the torch ones bit-equal to their numpy twins, u32 values
  near 2^32 included;
- the scorer: ``word_lookup`` and ``ngram_score`` equal to JAX's,
  exhaustively over the tiny LM's words and histories of up to 2 words
  (ARPA and binary), and to the host scorer within 1e-5;
- the decodes: ids equal to JAX's device beam and to the host beam with no
  LM, in the no-pruning regime (W=1024), with the unigram-only LM, with
  order 6 (``<s>`` pinned) and with the binary LM, where JAX's own tests
  hold JAX to the host beam (order 6 and binary: at least 8 rows of 10);
  in the pruned regime at most 4 of 20 rows differ from the host beam,
  each by less than 0.1 under float64 rescoring (JAX's limits); n-best
  hypotheses equal to JAX's, scores within 1e-5 relative;
- tie-heavy decodes (log-probs rounded to whole nats, so that only the
  index rule orders the equal totals): ids and n-best equal to JAX's;
- the on-disk table cache and the budget check.

Every distinct (width, LM, n-best, shape) is one XLA compile of JAX's
search, so each case runs its rows as one batch.
"""

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speecht_tpu import native as jnative
from speecht_tpu.ops import beam_device as jbd
from speecht_tpu_torch import native, vocabulary
from speecht_tpu_torch.ops import beam_device as bd
from test_beam_device import ARPA, _ctc_logp_f64, _lm_bonus_f64, _logp

FAVORED = [0, 19, 2, 7, 4, 18, 12, 27, 28]  # a t c h e s m space blank
FUSION = (1.5, 0.5, 1.2)
WORDS = ["the", "cat", "sat", "a", "mat", "zzz"]


def _order6_arpa():
    """test_beam_device.py's order-6 chain over <s> aa bb cc dd ee ff."""
    words = ["aa", "bb", "cc", "dd", "ee", "ff"]
    grams = {1: ["-1.5\t<unk>", "-0.5\t<s>\t-0.4", "-0.6\t</s>"]
             + [f"-1.{i}\t{w}\t-0.3" for i, w in enumerate(words)]}
    chain = ["<s>"] + words
    for n in range(2, 7):
        grams[n] = [f"-0.{n}{i}\t{' '.join(chain[i:i + n])}" + ("\t-0.2" if n < 6 else "")
                    for i in range(len(chain) - n + 1)]
    return _arpa_text(grams)


def _arpa_text(grams):
    text = "\\data\\\n" + "".join(f"ngram {n}={len(g)}\n" for n, g in grams.items())
    for n, g in grams.items():
        text += f"\n\\{n}-grams:\n" + "\n".join(g) + "\n"
    return text + "\n\\end\\\n"


UNIGRAM_ARPA = (
    "\\data\\\nngram 1=5\n\n\\1-grams:\n"
    "-1.5\t<unk>\n-0.5\t<s>\n-0.6\t</s>\n-0.8\tthe\n-1.1\tcat\n"
    "\n\\end\\\n"
)


def _two_choice_arpa(seed=0):
    """About 10^4 n-grams over 300 seeded words: enough keys that some
    primary buckets overflow, so the arena needs two-choice placement."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, size=rng.randint(2, 6)))
                    for _ in range(400)})[:300]
    grams = {1: ["-2.0\t<unk>", "-1.0\t<s>\t-0.3"]
             + [f"{-1 - rng.rand():.4f}\t{w}\t{-0.2 * rng.rand():.4f}" for w in words]}
    for n, count in ((2, 6000), (3, 4000)):
        ids = np.unique(rng.randint(0, len(words), size=(count, n)), axis=0)
        grams[n] = [f"{-rng.rand():.4f}\t{' '.join(words[i] for i in row)}"
                    + (f"\t{-0.1 * rng.rand():.4f}" if n < 3 else "") for row in ids]
    return _arpa_text(grams)


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("beam_device")
    (d / "model.arpa").write_text(ARPA)
    (d / "vocabulary").write_text("the\ncat\nsat\nmat\n")  # no "a"
    (d / "order6.arpa").write_text(_order6_arpa())
    (d / "unigram.arpa").write_text(UNIGRAM_ARPA)
    (d / "two_choice.arpa").write_text(_two_choice_arpa())
    jnative.lm_write_binary(str(d / "model.arpa"), str(d / "kenlm-model.binary"))
    return d


def _vocab(lm_dir, name):
    return str(lm_dir / "vocabulary") if name in ("model.arpa", "kenlm-model.binary") else None


@pytest.fixture(scope="module")
def lms(lm_dir):
    """(JAX's DeviceLM, the port's) per LM file."""
    out = {}
    for name in ("model.arpa", "order6.arpa", "unigram.arpa", "kenlm-model.binary"):
        path, vocab = str(lm_dir / name), _vocab(lm_dir, name)
        if name.endswith(".binary"):
            out[name] = (jbd.DeviceLM.from_binary(path, vocab),
                         bd.DeviceLM.from_binary(path, vocab))
        else:
            out[name] = (jbd.DeviceLM(path, vocab), bd.DeviceLM(path, vocab))
    return out


def _host_lm(lm_dir, name):
    return native.NGramLM(str(lm_dir / name), _vocab(lm_dir, name))


@pytest.mark.parametrize(
    "name", ["model.arpa", "order6.arpa", "unigram.arpa", "two_choice.arpa",
             "kenlm-model.binary"]
)
def test_tables_bit_equal_to_jax(lm_dir, name):
    path, vocab = str(lm_dir / name), _vocab(lm_dir, name)
    if name.endswith(".binary"):
        want_meta, want = jbd._build_np_from_binary(path, vocab)
        meta, got = bd._build_np_from_binary(path, vocab)
    else:
        want_meta, want = jbd._build_np_from_arpa(path, vocab)
        meta, got = bd._build_np_from_arpa(path, vocab)
    assert meta == want_meta
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
    if name == "two_choice.arpa":
        assert meta["arena_two_choice"] and len(got["arena_k"]) >= 4096
    lm = bd.DeviceLM._from_np(meta, got, None, "cpu")
    assert lm.hbm_bytes() == sum(a.size * 4 for a in want.values())
    for k, t in lm.tables.items():
        assert t.dtype == torch.int32 and np.array_equal(t.numpy(), want[k])


def test_kenlm_dump_matches_jax(lm_dir):
    path = str(lm_dir / "kenlm-model.binary")
    got, want = native.kenlm_dump(path), jnative.kenlm_dump(path)
    assert got.keys() == want.keys()
    assert got["order"] == want["order"] == 3
    assert got["words"] == want["words"]
    for k in ("uni_prob", "uni_back"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["tables"].keys() == want["tables"].keys() == {2, 3}
    for n in want["tables"]:
        for a, b in zip(got["tables"][n], want["tables"][n]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="cannot read KenLM binary"):
        native.kenlm_dump(str(lm_dir / "model.arpa"))


def _u32(t):
    return t.numpy().astype(np.uint64).astype(np.uint32)


@pytest.mark.parametrize("scheme", ["fnv", "kenlm"])
def test_key_hashes_bit_equal_to_numpy(scheme):
    rng = np.random.RandomState(3)
    for n in (1, 2, 3, 5, 6):
        ids = rng.randint(0, 1 << 31, size=(64, n), dtype=np.int64)
        ids[0] = (1 << 31) - 1
        ids[1] = 0
        if scheme == "fnv":
            want = bd._np_key_hash_rows(ids.astype(np.int32))
            got = bd._key_hash(torch.from_numpy(ids))
        else:
            want = bd._np_kenlm_key_hash_rows(ids)
            got = bd._kenlm_key_hash(torch.from_numpy(ids))
        np.testing.assert_array_equal(_u32(got[0]), want[0])
        np.testing.assert_array_equal(_u32(got[1]), want[1])
        # and JAX's device hashes agree
        jfn = jbd._key_hash if scheme == "fnv" else jbd._kenlm_key_hash
        jk = jfn(jnp.asarray(ids.astype(np.int32)))
        np.testing.assert_array_equal(np.asarray(jk[0]), want[0])
        np.testing.assert_array_equal(np.asarray(jk[1]), want[1])


def test_u32_products_near_2_32():
    rng = np.random.RandomState(5)
    a = np.concatenate([
        rng.randint(0, 1 << 32, size=500, dtype=np.uint64),
        (1 << 32) - 1 - rng.randint(0, 1 << 16, size=100).astype(np.uint64),
        np.array([0, 1, (1 << 31), (1 << 32) - 1], np.uint64),
    ])
    ta = torch.from_numpy(a.astype(np.int64))
    for m in (bd._M1, bd._M2, bd._KP2, bd._C1HI, bd._C1LO, bd._C2HI, bd._C2LO):
        want = (a.astype(object) * m) % (1 << 32)
        np.testing.assert_array_equal(bd._mul32(ta, m).numpy().astype(object), want)
        hi, lo = bd._mul32_wide(ta, m)
        full = a.astype(object) * m
        np.testing.assert_array_equal(hi.numpy().astype(object), full >> 32)
        np.testing.assert_array_equal(lo.numpy().astype(object), full % (1 << 32))
    # the rolling word hash of the search against its numpy twin
    for word in WORDS + ["it's", "abcdefghijklmnopqrstuvwxyz" * 3]:
        cids = bd._word_char_ids(word) or []
        h1 = torch.tensor([bd._WSEED1])
        h2 = torch.tensor([bd._WSEED2])
        for c in cids:
            h1 = (bd._mul32(h1, bd._M1) + c + 2) & bd._MASK32
            h2 = (bd._mul32(h2, bd._M2) + c + 2) & bd._MASK32
        want = bd._np_word_hash(np.array(cids, np.int64))
        assert (int(h1), int(h2)) == (int(want[0]), int(want[1]))


def _word_hashes(words):
    hs = [bd._np_word_hash(np.array(bd._word_char_ids(w), np.int64)) for w in words]
    return (np.array([h[0] for h in hs], np.int64), np.array([h[1] for h in hs], np.int64))


@pytest.mark.parametrize("name", ["model.arpa", "kenlm-model.binary"])
def test_scorer_matches_jax_exhaustively(lm_dir, lms, name):
    jlm, lm = lms[name]
    host = _host_lm(lm_dir, name)
    jwl, jns = jbd._make_lm_fns(jlm)
    wl, ns = bd._make_lm_fns(lm)
    H = lm.hist_len
    wh1, wh2 = _word_hashes(WORDS)
    wid, valid = wl(torch.from_numpy(wh1), torch.from_numpy(wh2))
    jwid, jvalid = jwl(jnp.asarray(wh1.astype(np.uint32)), jnp.asarray(wh2.astype(np.uint32)))
    np.testing.assert_array_equal(wid.numpy(), np.asarray(jwid))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert [bool(v) for v in valid] == [host.has_word(w) for w in WORDS]
    ids = dict(zip(WORDS, wid.tolist()))

    cases = [(hw, w) for n in range(3) for hw in itertools.product(WORDS, repeat=n)
             for w in WORDS]
    hist = np.zeros((len(cases), H), np.int64)
    hcnt = np.zeros(len(cases), np.int64)
    for r, (hw, _w) in enumerate(cases):
        toks = ([lm.bos_id] if lm.bos_id >= 0 else []) + [ids[x] for x in hw]
        toks = toks[-H:]
        hist[r, H - len(toks):] = toks
        hcnt[r] = min(len(toks), H)
    target = np.array([ids[w] for _hw, w in cases], np.int64)
    got = ns(torch.from_numpy(hist), torch.from_numpy(hcnt), torch.from_numpy(target))
    want = jns(jnp.asarray(hist.astype(np.int32)), jnp.asarray(hcnt.astype(np.int32)),
               jnp.asarray(target.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for (hw, w), s in zip(cases, got.tolist()):
        assert abs(host.score_word(" ".join(hw), w) - s) < 1e-5, (hw, w)


def _decode(W, pair, logp, lengths, weights, **kwargs):
    """(JAX's outputs, the port's) as numpy."""
    jlm, lm = pair if pair is not None else (None, None)
    want = jbd.make_device_beam_search(W, lm=jlm, **kwargs)(logp, lengths, *weights)
    got = bd.make_device_beam_search(W, lm=lm, **kwargs)(
        torch.from_numpy(logp), torch.from_numpy(lengths), *weights
    )
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _rows(ids, lens):
    return [[int(x) for x in ids[i, :lens[i]]] for i in range(len(lens))]


def _host_rows(logp, lengths, W, host_lm, weights):
    return [
        [int(x) for x in native.ctc_beam_search(
            logp[i, :lengths[i]], beam_width=W, lm=host_lm, lm_weight=weights[0],
            word_count_weight=weights[1], valid_word_count_weight=weights[2],
            blank_id=vocabulary.BLANK_ID)]
        for i in range(len(lengths))
    ]


def _assert_same(want, got):
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("W", [4, 16])
def test_no_lm_decodes_match(W):
    rng = np.random.RandomState(7 + W)
    logp = _logp(rng, 12, 40)
    lengths = rng.randint(3, 41, size=12).astype(np.int32)
    lengths[:2] = (0, 1)
    weights = (0.0, float(rng.choice([0.8, -0.5])), 0.0)
    want, got = _decode(W, None, logp, lengths, weights)
    _assert_same(want, got)
    rows = _rows(*got)
    assert rows == _host_rows(logp, lengths, W, None, weights)
    assert rows[0] == [] and (got[0][0] == vocabulary.PAD_ID).all()


def test_no_pruning_regime_exact(lm_dir, lms):
    """Wide enough to hold every reachable prefix: any difference in the
    fusion against the host beam must show here."""
    alph = [0, 19, 2, 27, 28]  # a t c space blank
    rng = np.random.RandomState(3)
    logits = np.full((6, 5, vocabulary.NUM_CLASSES), -40.0, np.float32)
    logits[:, :, alph] = rng.randn(6, 5, len(alph)).astype(np.float32) * 2.0
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lengths = rng.randint(2, 6, size=6).astype(np.int32)
    want, got = _decode(1024, lms["model.arpa"], logp, lengths, FUSION)
    _assert_same(want, got)
    assert _rows(*got) == _host_rows(logp, lengths, 1024, _host_lm(lm_dir, "model.arpa"),
                                     FUSION)


def _word_logp(seed, B, T):
    rng = np.random.RandomState(seed)
    logp = _logp(rng, B, T, scale=2.0, favored=FAVORED, boost=4.0)
    lengths = rng.randint(5, T + 1, size=B).astype(np.int32)
    return logp, lengths


@pytest.mark.parametrize(
    "name,W,least",
    [("unigram.arpa", 8, 5), ("order6.arpa", 8, 8), ("kenlm-model.binary", 12, 8)],
)
def test_lm_decodes_match(lm_dir, lms, name, W, least):
    """Equal to JAX's device beam on every row; the host beam on at least
    as many rows of 10 as JAX's own test asks of JAX (all for the unigram
    LM, 8 for order 6 and the binary)."""
    logp, lengths = _word_logp(9, 10, 30)
    want, got = _decode(W, lms[name], logp, lengths, FUSION)
    _assert_same(want, got)
    host = _host_rows(logp, lengths, W, _host_lm(lm_dir, name), FUSION)
    same = sum(a == b for a, b in zip(_rows(*got), host))
    assert same >= (10 if least == 5 else least), same


def test_binary_decodes_equal_arpa_decodes(lms):
    logp, lengths = _word_logp(17, 8, 40)
    _w, arpa = _decode(12, lms["model.arpa"], logp, lengths, FUSION)
    _w, binary = _decode(12, lms["kenlm-model.binary"], logp, lengths, FUSION)
    assert _rows(*arpa) == _rows(*binary)


def test_order6_bos_anchored_gram_decides_fifth_word(lm_dir, tmp_path):
    """test_beam_device.py's regression: only the <s>-anchored 6-gram,
    probed through the search's own history update after four words, turns
    the acoustically preferred 'f' into 'e'."""
    words = ["aa", "bb", "cc", "dd"]
    uni = ["-2.0\t<unk>", "-0.5\t<s>\t-0.1", "-0.6\t</s>"]
    uni += [f"-0.8\t{w}\t-0.1" for w in words] + ["-1.2\te\t-0.1", "-1.0\tf\t-0.1"]
    path = tmp_path / "model.arpa"
    path.write_text(_arpa_text({1: uni, 6: ["-0.05\t<s> aa bb cc dd e"]}))
    frames, prev = [], -1
    for c in vocabulary.sentence_to_ids("aa bb cc dd "):
        if c == prev:
            frames.append(vocabulary.BLANK_ID)
        frames.append(c)
        prev = c
    T = len(frames) + 1
    logits = np.full((1, T, vocabulary.NUM_CLASSES), -30.0, np.float32)
    for t, c in enumerate(frames):
        logits[0, t, c] = 0.0
    logits[0, -1, vocabulary.sentence_to_ids("e")[0]] = 0.0
    logits[0, -1, vocabulary.sentence_to_ids("f")[0]] = 0.5
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lengths = np.array([T], np.int32)
    pair = (jbd.DeviceLM(str(path)), bd.DeviceLM(str(path)))
    assert pair[1].hist_len == 5 and pair[1].bos_id >= 0
    want, got = _decode(8, pair, logp, lengths, (2.0, 0.0, 0.0))
    _assert_same(want, got)
    host = _host_rows(logp, lengths, 8, native.NGramLM(str(path), None), (2.0, 0.0, 0.0))
    assert _rows(*got) == host
    assert vocabulary.ids_to_sentence(_rows(*got)[0]) == "aa bb cc dd e"


def test_pruned_regime_near_total_agreement(lm_dir, lms):
    """W=12 on word-shaped emissions: JAX's device beam exactly, and the
    host beam on all but at most 4 of 20 rows, each a near tie (its two
    hypotheses within 0.1 under float64 rescoring)."""
    logp, lengths = _word_logp(42, 20, 40)
    want, got = _decode(12, lms["model.arpa"], logp, lengths, FUSION)
    _assert_same(want, got)
    host_lm = _host_lm(lm_dir, "model.arpa")
    host = _host_rows(logp, lengths, 12, host_lm, FUSION)
    mismatches = 0
    for i, (dev, ref) in enumerate(zip(_rows(*got), host)):
        if dev != ref:
            mismatches += 1
            row = logp[i, :lengths[i]].astype(np.float64)
            sh = _ctc_logp_f64(row, ref) + _lm_bonus_f64(host_lm, ref, *FUSION)
            sd = _ctc_logp_f64(row, dev) + _lm_bonus_f64(host_lm, dev, *FUSION)
            assert abs(sh - sd) < 0.1, (i, sh, sd)
    assert mismatches <= 4


@pytest.mark.parametrize("name", [None, "model.arpa", "order6.arpa"],
                         ids=["no_lm", "order3", "order6"])
def test_tie_heavy_decodes_match(lms, name):
    """Emissions rounded to whole nats (the likeliest char to -0.0): many
    chars of a frame share a log-prob, so the frame's top-K and the pool's
    totals tie often and only the index rule (the lower candidate first,
    as ``lax.top_k``) decides the order. Ids, lengths and the n-best scores
    equal to JAX's device beam."""
    logp, lengths = _word_logp(31, 6, 24)
    logp = np.round(logp).astype(np.float32)
    top = -np.sort(-logp, axis=-1)[..., :9]  # the top-8 and the next
    assert (np.diff(top, axis=-1) == 0).any(-1).mean() > 0.9
    pair = lms[name] if name else None
    want, got = _decode(8, pair, logp, lengths, FUSION, n_best=4)
    _assert_same(want[:2], got[:2])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


def test_n_best_matches_jax(lms):
    logp, lengths = _word_logp(21, 4, 30)
    want, got = _decode(12, lms["model.arpa"], logp, lengths, FUSION, n_best=5)
    (wids, wlens, wscores), (ids, lens, scores) = want, got
    assert ids.shape == (4, 5, 30) and scores.shape == (4, 5)
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_array_equal(lens, wlens)
    np.testing.assert_allclose(scores, wscores, rtol=1e-5)
    assert (np.diff(scores, axis=1) <= 0).all()
    for b in range(4):
        live = [tuple(ids[b, n, :lens[b, n]]) for n in range(5) if scores[b, n] > -1e29]
        assert len(set(live)) == len(live)  # distinct prefixes
    _w, (top1, top1_len) = _decode(12, lms["model.arpa"], logp, lengths, FUSION)
    assert _rows(top1, top1_len) == _rows(ids[:, 0], lens[:, 0])


def test_n_best_bounds():
    for n in (0, 5):
        with pytest.raises(ValueError, match="n_best"):
            bd.make_device_beam_search(4, n_best=n)


def test_weights_are_call_arguments(lms):
    """One search, other fusion weights, other decodes: the weights are
    arguments of each call."""
    fn = bd.make_device_beam_search(8, lm=lms["model.arpa"][1])
    logp, _ = _word_logp(5, 1, 30)
    lengths = torch.tensor([30], dtype=torch.int32)
    outs = set()
    for lw in (0.0, 2.0, 8.0):
        ids, lens = fn(torch.from_numpy(logp), lengths, lw, 0.5, 1.2)
        outs.add(vocabulary.ids_to_sentence(ids[0, :lens[0]].tolist()))
    assert len(outs) >= 2


def test_lm_robustness(tmp_path):
    """A duplicated n-gram keeps its last row (the host's map assignment);
    a file with no n-grams raises; malformed rows are skipped."""
    dup = "\n".join("-%d.0\tthe cat\t-0.1" % p for p in (1, 2, 3, 4, 5))
    path = tmp_path / "dup.arpa"
    path.write_text(
        "\\data\\\nngram 1=4\nngram 2=5\n\n\\1-grams:\n-1.5\t<unk>\n"
        "-0.5\t<s>\t-0.4\n-0.9\tthe\t-0.3\n-1.2\tcat\n\n\\2-grams:\n" + dup
        + "\n\n\\end\\\n"
    )
    lm = bd.DeviceLM(str(path))
    wl, ns = bd._make_lm_fns(lm)
    wh1, wh2 = _word_hashes(["the", "cat"])
    wid, _ = wl(torch.from_numpy(wh1), torch.from_numpy(wh2))
    toks = ([lm.bos_id] if lm.bos_id >= 0 else []) + [int(wid[0])]
    toks = toks[-lm.hist_len:]
    got = float(ns(torch.tensor([toks]), torch.tensor([len(toks)]), wid[1:]))
    assert got == native.NGramLM(str(path), None).score_word("the", "cat") == -5.0
    for name, text in (("garbage", b"\x00\x01 not an arpa file \xff"), ("empty", b"")):
        bad = tmp_path / f"{name}.arpa"
        bad.write_bytes(text)
        with pytest.raises(ValueError, match="no n-grams"):
            bd.DeviceLM(str(bad))
    bad = tmp_path / "malformed.arpa"
    bad.write_text("\\data\\\nngram 1=3\n\n\\1-grams:\n-1.0\t<unk>\nnotafloat\tthe\n"
                   "-0.9\n-0.8\tcat\t-0.2\n\n\\end\\\n")
    assert bd.DeviceLM(str(bad)).order == 1


class TestCache:
    """``DeviceLM.cached``: the packed tables in an npz keyed by the LM's
    and vocabulary's content."""

    def _paths(self, lm_dir):
        return str(lm_dir / "model.arpa"), str(lm_dir / "vocabulary")

    def test_second_load_is_bit_identical_and_skips_build(self, lm_dir, tmp_path,
                                                          monkeypatch):
        cache = str(tmp_path / "cache")
        first = bd.DeviceLM.cached(*self._paths(lm_dir), cache_dir=cache)
        (entry,) = os.listdir(cache)
        assert entry.endswith(".npz")

        def boom(*a, **k):
            raise AssertionError("cache miss: the table build ran again")

        monkeypatch.setattr(bd, "_build_np_from_arpa", boom)
        monkeypatch.setattr(bd, "_build_np_from_binary", boom)
        second = bd.DeviceLM.cached(*self._paths(lm_dir), cache_dir=cache)
        for k in first.tables:
            assert torch.equal(first.tables[k], second.tables[k])
        for attr in ("order", "hist_len", "key_scheme", "unk_id", "bos_id",
                     "unk_floor", "arena_two_choice", "words_two_choice"):
            assert getattr(first, attr) == getattr(second, attr), attr
        # the JAX package's cache reads the same entry
        jlm = jbd.DeviceLM.cached(*self._paths(lm_dir), cache_dir=cache)
        for k in first.tables:
            np.testing.assert_array_equal(first.tables[k].numpy(), np.asarray(jlm.tables[k]))

    def test_changed_file_rebuilds_and_binary_matches_direct(self, lm_dir, tmp_path):
        cache = str(tmp_path / "cache")
        arpa, vocab = self._paths(lm_dir)
        bd.DeviceLM.cached(arpa, vocab, cache_dir=cache)
        changed = tmp_path / "model.arpa"
        changed.write_text(ARPA.replace("-0.9", "-0.7", 1))
        bd.DeviceLM.cached(str(changed), vocab, cache_dir=cache)
        assert len(os.listdir(cache)) == 2
        binary = str(lm_dir / "kenlm-model.binary")
        direct = bd.DeviceLM.from_binary(binary, vocab)
        cached = bd.DeviceLM.cached(binary, vocab, cache_dir=cache)
        assert cached.key_scheme == "kenlm" and len(os.listdir(cache)) == 3
        for k in direct.tables:
            assert torch.equal(direct.tables[k], cached.tables[k])

    def test_evicts_lru_beyond_byte_budget(self, lm_dir, tmp_path, monkeypatch):
        cache = str(tmp_path / "cache")
        arpa, vocab = self._paths(lm_dir)
        monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE_MAX_BYTES", "1")
        bd.DeviceLM.cached(arpa, vocab, cache_dir=cache)
        (first,) = os.listdir(cache)  # the entry just written stays
        os.utime(os.path.join(cache, first), (1.0, 1.0))
        changed = tmp_path / "model.arpa"
        changed.write_text(ARPA.replace("-0.9", "-0.6", 1))
        bd.DeviceLM.cached(str(changed), vocab, cache_dir=cache)
        (kept,) = os.listdir(cache)
        assert kept != first  # the stale entry was evicted
        os.utime(os.path.join(cache, kept), (1.0, 1.0))
        bd.DeviceLM.cached(str(changed), vocab, cache_dir=cache)
        assert os.stat(os.path.join(cache, kept)).st_mtime > 1.0  # a hit is recent

    def test_default_directory_is_the_ports(self, lm_dir, tmp_path, monkeypatch):
        monkeypatch.delenv("SPEECHT_DEVICE_LM_CACHE", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path))
        bd.DeviceLM.cached(*self._paths(lm_dir))
        assert len(os.listdir(tmp_path / ".cache" / "speecht_tpu_torch" / "device_lm")) == 1
        monkeypatch.setenv("SPEECHT_DEVICE_LM_CACHE", str(tmp_path / "env"))
        bd.DeviceLM.cached(*self._paths(lm_dir))
        assert len(os.listdir(tmp_path / "env")) == 1

    def test_budget_error_before_any_copy(self, lm_dir, tmp_path, monkeypatch):
        cache = str(tmp_path / "cache")
        bd.DeviceLM.cached(*self._paths(lm_dir), cache_dir=cache)

        def no_copy(*a, **k):
            raise AssertionError("a table was copied before the budget check")

        monkeypatch.setattr(torch, "from_numpy", no_copy)
        with pytest.raises(bd.DeviceLMBudgetError) as e:
            bd.DeviceLM.cached(*self._paths(lm_dir), hbm_budget_bytes=16, cache_dir=cache)
        assert e.value.bytes_needed > 16 and e.value.budget_bytes == 16

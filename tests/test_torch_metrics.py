"""The port's copy of the caption metrics against the original
(rtvc_tpu_torch.metrics vs rtvc_tpu.metrics).

The copy exists because importing ``rtvc_tpu`` imports jax. Every public
function must give exactly the original's result (``==`` on floats, equal
token lists and tables) on the fixed cases of tests/test_metrics.py and on
300 seeded random caption pairs: PTB tokenization, the Porter stemmer,
BLEU-1..4, ROUGE-L, CIDEr-D, METEOR-lite (the exact aligner, its greedy
fallback past the search budget, and the synonym stage fed a table loaded
from a group file and from a WordNet-format directory),
``evaluate_captions``, ``load_coco_annotations``, ``calculate_score`` and
``calculate_bleu_score_corpus``.
"""

import json

import numpy as np
import pytest

from rtvc_tpu import metrics as jm
from rtvc_tpu_torch import metrics as pm

# the inputs of tests/test_metrics.py
FIXED_TEXTS = [
    "A man, running!", "don't stop", "a man is running",
    "a dog plays with a ball", "someone runs", "a man runs",
    "The cat (a tabby) sat -- on the mat... didn't it?",
    "I cannot wanna gonna gotta lemme gimme", "{braces} [brackets] ``quotes''",
    "", "   ", "man's dog's", "a-b well-known", "U.S. 3.14 $5 50%",
]
FIXED_PAIRS = [
    (["a", "man", "is", "running", "fast"], ["a", "man", "is", "running",
                                              "fast"]),
    (["the", "cat", "sat", "on", "the", "mat"], ["the", "cat", "on", "the",
                                                  "mat"]),
    (["a"] * 10, ["a"] * 5), (["a"] * 10, ["a"] * 10),
    (["a", "b", "c", "d"], ["a", "x", "c", "y"]),
    (["a", "man", "rides", "a", "horse"], ["blue", "sky", "over", "city"]),
    (["a", "man", "is", "playing", "guitar"], ["a", "man", "plays",
                                               "guitar"]),
    (["a", "man", "is", "playing", "guitar"], ["purple", "elephant",
                                               "dances"]),
    (["a", "kid", "on", "a", "bike"], ["a", "child", "on", "a", "cycle"]),
    (["the", "man", "rode", "his", "bicycle"], ["the", "man", "rode", "his",
                                                "bike"]),
    (["a"], []), ([], ["a"]),
]
STEM_WORDS = (
    "caresses ponies ties caress cats feed agreed plastered bled motoring "
    "sing conflated troubled sized hopping tanned falling hissing fizzed "
    "failing filing happy sky relational conditional rational valenci "
    "hesitanci digitizer conformabli radicalli differentli vileli "
    "analogousli vietnamization predication operator feudalism decisiveness "
    "hopefulness callousness formaliti sensitiviti sensibiliti triplicate "
    "formative formalize electriciti electrical hopeful goodness revival "
    "allowance inference airliner gyroscopic adjustable defensible "
    "irritant replacement adjustment dependent adoption homologou "
    "communism activate angulariti homologous effective bowdlerize "
    "probate rate cease controll roll generalizations oscillators "
    "a is as at be by").split()
WORDS = (
    "a an the man woman dog cat kid child people group is are was playing "
    "plays played play riding rides ride cooking cooks singing sings song "
    "guitar piano bike bicycle cycle car auto street road sofa couch on in "
    "at with of to outdoors room kitchen night very really nicely thing "
    "object item news video game ball soccer talking about driving "
    "running runs run don't it's man's , . ! ? - -- ( ) ; : ''").split()
SYNONYM_GROUPS = "bike, bicycle, cycle\nkid child\ncar auto\nsofa couch\n" \
                 "street road\nplaying plays\n"


def _random_pairs(n: int = 300):
    """Seeded (reference, candidate) word lists: candidates copy, drop,
    swap, repeat and replace the reference's words."""
    rng = np.random.default_rng(23)
    pairs = []
    for _ in range(n):
        ref = list(rng.choice(WORDS, size=int(rng.integers(1, 14))))
        cand = list(ref)
        for _ in range(int(rng.integers(0, 4))):
            op = int(rng.integers(4))
            i = int(rng.integers(len(cand))) if cand else 0
            if op == 0 and cand:
                del cand[i]
            elif op == 1 and len(cand) > 1:
                j = min(i + 1, len(cand) - 1)
                cand[i], cand[j] = cand[j], cand[i]
            elif op == 2 and cand:
                cand.insert(i, cand[i])
            else:
                cand.insert(i, str(rng.choice(WORDS)))
        pairs.append((ref, cand))
    return pairs


PAIRS = FIXED_PAIRS + _random_pairs()
TEXTS = FIXED_TEXTS + [" ".join(r) for r, _ in PAIRS] + [
    " ".join(c) for _, c in PAIRS]


def _corpora(pairs, refs_per_item: int = 1):
    """(gts, res) dicts over ``pairs``, grouped ``refs_per_item`` references
    an item (the next pairs' references join the first's)."""
    gts, res = {}, {}
    for i in range(0, len(pairs), refs_per_item):
        group = pairs[i:i + refs_per_item]
        gts[str(i)] = [r for r, _ in group]
        res[str(i)] = group[0][1]
    return gts, res


def test_ptb_tokenize_equals_original():
    for text in TEXTS:
        assert pm.ptb_tokenize(text) == jm.ptb_tokenize(text), text


def test_porter_stem_equals_original():
    for w in STEM_WORDS + WORDS:
        assert pm.porter_stem(w) == jm.porter_stem(w), w


@pytest.mark.parametrize("refs_per_item", [1, 3])
@pytest.mark.parametrize("scorer", ["bleu", "rouge_l", "cider"])
def test_corpus_scores_equal_original(scorer, refs_per_item):
    gts, res = _corpora(PAIRS, refs_per_item)
    assert getattr(pm, scorer)(gts, res) == getattr(jm, scorer)(gts, res)
    for ref, cand in PAIRS:  # one item at a time, too
        one = ({"0": [ref]}, {"0": cand})
        assert getattr(pm, scorer)(*one) == getattr(jm, scorer)(*one)


@pytest.mark.parametrize("refs_per_item", [1, 3])
def test_meteor_equals_original(refs_per_item):
    gts, res = _corpora(PAIRS, refs_per_item)
    assert pm.meteor_lite(gts, res) == jm.meteor_lite(gts, res)
    for ref, cand in PAIRS:
        assert (pm._meteor_align(cand, ref)
                == jm._meteor_align(cand, ref)), (ref, cand)


def test_meteor_greedy_fallback_equals_original(monkeypatch):
    """Past the exact search's node budget both fall back to the staged
    greedy scan, with the same results."""
    monkeypatch.setattr(jm, "_ALIGN_SEARCH_BUDGET", 3)
    monkeypatch.setattr(pm, "_ALIGN_SEARCH_BUDGET", 3)
    worst = (["a"] * 30, ["a"] * 30)
    for ref, cand in PAIRS + [worst]:
        assert (pm._meteor_align(cand, ref)
                == jm._meteor_align(cand, ref)), (ref, cand)
        assert pm._align_greedy(cand, ref) == jm._align_greedy(cand, ref)
    gts, res = _corpora(PAIRS)
    assert pm.meteor_lite(gts, res) == jm.meteor_lite(gts, res)


def _wordnet_dir(root):
    """A WordNet-format database directory (index.noun + data.noun)."""
    root.mkdir()
    (root / "data.noun").write_text(
        "  1 header line to skip\n"
        "00001111 03 n 02 bike 0 bicycle 0 001 @ 00002222 n 0000 | a cycle\n"
        "00003333 03 n 02 kid 0 child 0 001 @ 00002222 n 0000 | a child\n")
    (root / "index.noun").write_text(
        "  1 header line to skip\n"
        "bike n 1 1 @ 1 0 00001111\n"
        "bicycle n 1 1 @ 1 0 00001111\n"
        "kid n 1 1 @ 1 0 00003333\n")
    return root


@pytest.mark.parametrize("source", ["group file", "database dir"])
def test_synonym_stage_equals_original(tmp_path, source):
    if source == "group file":
        path = tmp_path / "syns.txt"
        path.write_text(SYNONYM_GROUPS)
    else:
        path = _wordnet_dir(tmp_path / "wordnet")
    jt, pt = (jm.load_wordnet_synonyms(str(path)),
              pm.load_wordnet_synonyms(str(path)))
    assert pt.table == jt.table
    for w in WORDS:
        assert pt(w) == jt(w)
    gts, res = _corpora(PAIRS, 2)
    assert (pm.meteor_lite(gts, res, synonyms=pt)
            == jm.meteor_lite(gts, res, synonyms=jt))
    for ref, cand in PAIRS:
        assert (pm._meteor_align(cand, ref, pt)
                == jm._meteor_align(cand, ref, jt))
    # the module default, installed and cleared by set_wordnet_path
    try:
        assert pm.set_wordnet_path(str(path)) and jm.set_wordnet_path(
            str(path))
        assert pm.meteor_lite(gts, res) == jm.meteor_lite(gts, res)
    finally:
        pm.set_wordnet_path("")
        jm.set_wordnet_path("")
    assert pm._WORDNET_SYNONYMS is None


def _outputs_and_annotations():
    texts = [" ".join(c) for _, c in PAIRS]
    refs = [" ".join(r) for r, _ in PAIRS]
    outputs = [{"image_id": f"video{i}", "caption": texts[i]}
               for i in range(0, len(texts), 3)]
    annotations = {f"video{i}": refs[i:i + 3]
                   for i in range(0, len(refs), 3)}
    outputs.append({"image_id": "unannotated", "caption": "a man"})
    return outputs, annotations


def test_evaluate_captions_equals_original():
    outputs, annotations = _outputs_and_annotations()
    got = pm.evaluate_captions(outputs, annotations)
    assert got == jm.evaluate_captions(outputs, annotations)
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                        "ROUGE_L", "CIDEr"}
    assert pm.evaluate_captions(outputs[-1:], annotations) == {}


def test_annotations_and_calculate_score_equal_original(tmp_path, capsys):
    outputs, annotations = _outputs_and_annotations()
    ann = {"annotations": [{"image_id": vid, "caption": c, "id": k}
                           for k, (vid, caps) in enumerate(
                               annotations.items()) for c in caps]}
    ann_file = tmp_path / "ann.json"
    ann_file.write_text(json.dumps(ann))
    assert (pm.load_coco_annotations(str(ann_file))
            == jm.load_coco_annotations(str(ann_file)) == annotations)
    got, want = {}, {}
    for name, mod, out in (("port", pm, got), ("jax", jm, want)):
        run = tmp_path / name
        out.update(mod.calculate_score(outputs, str(run / "log.txt"),
                                       str(run), ann_file=str(ann_file)))
        out["stdout"] = capsys.readouterr().out
    assert got == want
    for f in ("log.txt", "validation_preds.json"):
        assert ((tmp_path / "port" / f).read_text()
                == (tmp_path / "jax" / f).read_text())


def test_corpus_bleu_equals_original():
    refs = [[" ".join(r)] for r, _ in PAIRS]
    cands = [" ".join(c) for _, c in PAIRS]
    for lo in range(0, len(PAIRS), 8):  # batches of 8, as evaluate scores
        assert (pm.calculate_bleu_score_corpus(refs[lo:lo + 8],
                                               cands[lo:lo + 8])
                == jm.calculate_bleu_score_corpus(refs[lo:lo + 8],
                                                  cands[lo:lo + 8]))
    multi = [[" ".join(r) for r, _ in PAIRS[i:i + 3]]
             for i in range(0, len(PAIRS), 3)]
    cands3 = cands[::3]
    assert (pm.calculate_bleu_score_corpus(multi, cands3)
            == jm.calculate_bleu_score_corpus(multi, cands3))
    with pytest.raises(AssertionError):
        pm.calculate_bleu_score_corpus(refs, cands[:-1])

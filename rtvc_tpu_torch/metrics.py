"""COCO-style captioning metrics, pure Python (no Java, no pycocoevalcap).

A copy of ``rtvc_tpu/metrics.py``, its code unchanged: importing
``rtvc_tpu`` imports jax. tests/test_torch_metrics.py holds the
copy equal to the original.

Replaces the reference metric stack (reference src/metrics.py:16-68) which
shelled out to pycocotools + pycocoevalcap (whose PTBTokenizer and METEOR are
Java jars) and nltk. Implemented here from the published metric definitions:

- :func:`ptb_tokenize` — a Python reimplementation of the PTBTokenizer
  behavior pycocoevalcap applies before scoring (lowercase, drop a fixed
  punctuation list, split clitics/hyphens like the Stanford tokenizer does
  for the caption domain);
- :func:`bleu` — COCO BLEU-1..4 with "closest" reference-length brevity
  penalty (Papineni et al. 2002, as configured in coco-caption);
- :func:`rouge_l` — ROUGE-L F-measure with beta=1.2 (Lin 2004, coco-caption
  configuration);
- :func:`cider` — CIDEr-D as pycocoevalcap computes it (clipped TF-IDF
  n-gram similarity with the sigma=6 length gaussian, n=1..4 averaged, x10);
- :func:`meteor_lite` — Python METEOR with the standard parameters
  (alpha .9, beta 3, gamma .5) and all three match stages: exact,
  Porter-stem, and WordNet-synonym (the third activates when synonym data
  is installed via ``cfg.data.wordnet_path`` / :func:`set_wordnet_path`;
  the repository holds no WordNet data, so the default run is
  exact+stem). Divergence vs an independent implementation is MEASURED,
  not asserted: 95% of caption pairs score identically to nltk's METEOR in
  the same mode, mean abs delta 0.0026, worst 0.133 on duplicate-word
  tie-breaks (docs/METRICS.md; tests/test_metrics.py);
- :func:`calculate_score` — the epoch-end sweep (reference metrics.py:16-39):
  scores x100, printed and appended to the run file, preds dumped to JSON;
- :func:`calculate_bleu_score_corpus` — per-step corpus BLEU-4 x100
  (reference metrics.py:42-68). The reference's word_tokenize loop was a
  no-op (it rebound loop variables), so scoring effectively ran on
  character-split strings via nltk; here tokenization actually happens
  (documented fix, SURVEY.md §"known reference bugs").
"""

from __future__ import annotations

import json
import math
import os
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

# --------------------------------------------------------------------------
# PTB-style tokenization (coco-caption preprocessing)
# --------------------------------------------------------------------------

# Punctuation removed by pycocoevalcap's PTBTokenizer wrapper.
_PTB_PUNCT = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

_CLITICS = re.compile(r"\b(\w+)(n't|'ll|'re|'ve|'s|'m|'d)\b",
                      flags=re.IGNORECASE)

# PTB "assimilations": multi-word contractions the Stanford lexer splits.
_ASSIMILATIONS = re.compile(
    r"\b(cannot|gonna|gotta|wanna|lemme|gimme)\b")
_ASSIM_SPLIT = {"cannot": "can not", "gonna": "gon na", "gotta": "got ta",
                "wanna": "wan na", "lemme": "lem me", "gimme": "gim me"}

# Stanford normalizes brackets/quotes to PTB names (all on the removal
# list above, so they vanish from scored tokens — unlike a raw '"').
_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-",
             "[": "-LRB-", "]": "-RRB-", '"': "''"}

# Letter classes are Unicode ([^\W\d_] = any letter), not [a-z]: the
# Stanford lexer keeps accented words whole ('naïve' is ONE token), so an
# ASCII-only word class would shred any non-ASCII caption into per-symbol
# tokens and corrupt its n-gram counts.
_PTB_TOKEN = re.compile(
    r"(?:[^\W\d_]\.){2,}"         # acronyms stay whole: u.s.
    r"|\d+(?:[.,:]\d+)*"          # numbers keep internal . , : — 3.5, 3,000
    r"|n't|'[^\W\d_]+"            # clitic pieces after the pre-split
    r"|[^\W_]+(?:[-'][^\W_]+)*"   # words; hyphens/apostrophes internal
    r"|--|\.\.\."                 # PTB multi-char punct
    r"|[^\w\s]|_"                 # any other symbol, one token each
)


def ptb_tokenize(caption: str) -> List[str]:
    """coco-caption preprocessing: Stanford PTBTokenizer ``-lowerCase``
    (reference src/metrics.py via pycocoevalcap) then the wrapper's
    punctuation removal. Matches the jar's lexer on the cases that reach
    caption n-grams: clitics split (``can't`` -> ``ca n't``),
    assimilations split (``gonna`` -> ``gon na``), decimal/grouped
    numbers stay whole (``3.5``, ``3,000``), acronyms stay whole
    (``u.s.``), ``$``/``%`` split off, quotes/brackets normalize to PTB
    names and are then removed. Cross-checked against nltk's independent
    TreebankWordTokenizer (tests/test_metrics.py)."""
    text = caption.lower().strip()
    # split standard clitics the way PTB does: don't -> do n't, it's -> it 's
    def _split(m: re.Match) -> str:
        return m.group(1) + " " + m.group(2)
    text = _CLITICS.sub(_split, text)
    text = _ASSIMILATIONS.sub(lambda m: _ASSIM_SPLIT[m.group(1)], text)
    tokens = [_BRACKETS.get(t, t) for t in _PTB_TOKEN.findall(text)]
    return [t for t in tokens if t not in _PTB_PUNCT]


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# --------------------------------------------------------------------------
# BLEU (coco-caption configuration)
# --------------------------------------------------------------------------

def bleu(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]],
         max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n over pre-tokenized captions.

    ``gts[id]`` = list of reference token lists; ``res[id]`` = candidate
    token list. Uses clipped n-gram precision, geometric mean, and the
    'closest' reference length brevity penalty (coco-caption default).
    """
    correct = [0] * max_n
    total = [0] * max_n
    cand_len = 0
    ref_len = 0
    for img_id, refs in gts.items():
        cand = res[img_id]
        cand_len += len(cand)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cand_ng = _ngrams(cand, n)
            max_ref = Counter()
            for r in refs:
                for ng, cnt in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], cnt)
            correct[n - 1] += sum(min(cnt, max_ref[ng]) for ng, cnt in cand_ng.items())
            total[n - 1] += max(0, len(cand) - n + 1)
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    scores = []
    log_sum = 0.0
    tiny, small = 1e-15, 1e-9
    for n in range(max_n):
        # coco-caption adds tiny/small smoothing inside the ratio
        prec = (correct[n] + tiny) / (total[n] + small)
        log_sum += math.log(prec)
        scores.append(bp * math.exp(log_sum / (n + 1)))
    return scores


# --------------------------------------------------------------------------
# ROUGE-L (coco-caption configuration: F with beta=1.2)
# --------------------------------------------------------------------------

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]],
            beta: float = 1.2) -> float:
    scores = []
    for img_id, refs in gts.items():
        cand = res[img_id]
        best = 0.0
        for ref in refs:
            lcs = _lcs_len(cand, ref)
            if lcs == 0:
                continue
            prec = lcs / len(cand) if cand else 0.0
            rec = lcs / len(ref) if ref else 0.0
            if prec and rec:
                f = ((1 + beta ** 2) * prec * rec) / (rec + beta ** 2 * prec)
                best = max(best, f)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


# --------------------------------------------------------------------------
# CIDEr (Vedantam et al. 2015, coco-caption Cider class)
# --------------------------------------------------------------------------

def cider(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]],
          max_n: int = 4, sigma: float = 6.0) -> float:
    doc_freq: Dict[int, Counter] = {n: Counter() for n in range(1, max_n + 1)}
    for refs in gts.values():
        for n in range(1, max_n + 1):
            seen = set()
            for ref in refs:
                seen.update(_ngrams(ref, n).keys())
            for ng in seen:
                doc_freq[n][ng] += 1
    num_imgs = len(gts)
    log_ref = math.log(max(num_imgs, 1))

    def tfidf_vec(tokens: Sequence[str], n: int) -> Tuple[Dict[tuple, float], float, int]:
        counts = _ngrams(tokens, n)
        length = len(tokens)
        vec: Dict[tuple, float] = {}
        norm_sq = 0.0
        for ng, cnt in counts.items():
            df = math.log(max(doc_freq[n][ng], 1.0))
            w = (cnt / 1.0) * max(log_ref - df, 0.0)
            vec[ng] = w
            norm_sq += w * w
        return vec, math.sqrt(norm_sq), length

    scores = []
    for img_id, refs in gts.items():
        cand = res[img_id]
        score_n = []
        for n in range(1, max_n + 1):
            cvec, cnorm, clen = tfidf_vec(cand, n)
            sim_total = 0.0
            for ref in refs:
                rvec, rnorm, rlen = tfidf_vec(ref, n)
                # CIDEr-D: clipped dot product + length gaussian penalty
                dot = sum(min(w, rvec.get(ng, 0.0)) * rvec.get(ng, 0.0)
                          for ng, w in cvec.items())
                delta = clen - rlen
                if cnorm > 0 and rnorm > 0:
                    sim = (dot / (cnorm * rnorm)) * math.exp(
                        -(delta ** 2) / (2 * sigma ** 2))
                else:
                    sim = 0.0
                sim_total += sim
            score_n.append(sim_total / max(len(refs), 1))
        scores.append(10.0 * sum(score_n) / max_n)
    return sum(scores) / max(len(scores), 1)


# --------------------------------------------------------------------------
# METEOR (python approximation: exact + Porter stems; no WordNet offline)
# --------------------------------------------------------------------------

def _cons(w: str, i: int) -> bool:
    """True if w[i] is a consonant in Porter's sense ('y' after a consonant
    counts as a vowel)."""
    c = w[i]
    if c in "aeiou":
        return False
    if c == "y":
        return i == 0 or not _cons(w, i - 1)
    return True


def _measure(w: str) -> int:
    """Porter's m: the number of VC sequences in [C](VC){m}[V]."""
    n = 0
    i = 0
    while i < len(w) and _cons(w, i):
        i += 1
    while i < len(w):
        while i < len(w) and not _cons(w, i):
            i += 1
        if i >= len(w):
            break
        n += 1
        while i < len(w) and _cons(w, i):
            i += 1
    return n


def _has_vowel(w: str) -> bool:
    return any(not _cons(w, i) for i in range(len(w)))


def _double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    """*o: stem ends consonant-vowel-consonant, final not w/x/y."""
    return (len(w) >= 3 and _cons(w, len(w) - 3)
            and not _cons(w, len(w) - 2) and _cons(w, len(w) - 1)
            and w[-1] not in "wxy")


# (suffix, replacement) rule tables for steps 2-4, longest suffix first so a
# match selects the paper's single applicable rule.
_STEP2 = sorted([
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
    ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
    ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
    ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
    ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
    ("iviti", "ive"), ("biliti", "ble"),
], key=lambda r: -len(r[0]))
_STEP3 = sorted([
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""),
], key=lambda r: -len(r[0]))
_STEP4 = sorted([
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
], key=len, reverse=True)


def porter_stem(word: str) -> str:
    """The full Porter stemming algorithm (Porter 1980), as METEOR's stem
    module applies it — replaces the round-1 suffix-stripper approximation.
    Validated against nltk's ORIGINAL_ALGORITHM mode (tests/test_metrics.py).
    """
    w = word.lower()
    if len(w) <= 2:
        return w

    # ---- step 1a --------------------------------------------------------
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # ---- step 1b --------------------------------------------------------
    fired = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        fired = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        fired = True
    if fired:
        if w.endswith(("at", "bl", "iz")):
            w = w + "e"
        elif _double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w = w + "e"

    # ---- step 1c --------------------------------------------------------
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # ---- step 2 ---------------------------------------------------------
    for suf, rep in _STEP2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # ---- step 3 ---------------------------------------------------------
    for suf, rep in _STEP3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # ---- step 4 ---------------------------------------------------------
    for suf in _STEP4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1 and (suf != "ion" or stem[-1:] in ("s", "t")):
                w = stem
            break

    # ---- step 5a --------------------------------------------------------
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem

    # ---- step 5b --------------------------------------------------------
    if _measure(w) > 1 and _double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# round-1 name kept as an alias (the approximation it named is gone)
_porter_stem = porter_stem


def _match_edges(cand: Sequence[str], ref: Sequence[str],
                 synonyms=None) -> List[List[int]]:
    """edges[i] = sorted ref indices j that cand word i can match.

    A pair matches when the words are equal, Porter-stem equal, or — with a
    synonym table loaded — when r is among the lemma names of c's synsets
    (``synonyms(c)``), mirroring the Java METEOR / nltk rule. Stage
    precedence (exact → stem → synonym) only labels a pair; with unweighted
    match counts the METEOR score depends solely on (#matches, #chunks), so
    the stages pool into one match relation exactly as the Java aligner
    pools its matchers before resolving the alignment."""
    stems = {w: porter_stem(w) for w in set(cand) | set(ref)}
    edges: List[List[int]] = []
    for cw in cand:
        syn = synonyms(cw) if synonyms is not None else ()
        edges.append([j for j, rw in enumerate(ref)
                      if cw == rw or stems[cw] == stems[rw] or rw in syn])
    return edges


class _AlignBudget(Exception):
    pass


# Node cap for the exact alignment search. Real captions (≤ ~40 tokens,
# few duplicate words) resolve in well under 1k states; the cap only
# trips on adversarial inputs (e.g. the same word 40×40), where the
# greedy fallback's in-order scan is chunk-optimal anyway.
_ALIGN_SEARCH_BUDGET = 200_000


def _align_exact(edges: List[List[int]]) -> Tuple[int, int]:
    """Resolve the alignment the way the Java METEOR does (Meteor 1.5
    Aligner semantics, reference metrics.py:16-39 via pycocoevalcap):
    among alignments where each word is covered at most once, pick the one
    that (1) maximizes matches, (2) minimizes chunks, (3) minimizes the
    summed |i−j| distance. Exhaustive memoized search over candidate
    positions — exact, not greedy or beam-limited, feasible because
    caption pairs are tiny."""
    n = len(edges)
    memo: dict = {}
    nodes = 0

    def go(i: int, mask: int, prev_j: int) -> Tuple[int, int, int]:
        nonlocal nodes
        if i == n:
            return (0, 0, 0)
        key = (i, mask, prev_j)
        hit = memo.get(key)
        if hit is not None:
            return hit
        nodes += 1
        if nodes > _ALIGN_SEARCH_BUDGET:
            raise _AlignBudget
        nm, ch, ds = go(i + 1, mask, -2)          # leave cand word i unmatched
        best = (nm, ch, ds)
        for j in edges[i]:
            bit = 1 << j
            if mask & bit:
                continue
            chunk_inc = 0 if prev_j == j - 1 else 1
            snm, sch, sds = go(i + 1, mask | bit, j)
            trial = (snm - 1, sch + chunk_inc, sds + abs(i - j))
            if trial < best:
                best = trial
        memo[key] = best
        return best

    neg_matches, chunks, _dist = go(0, 0, -2)
    return -neg_matches, chunks


def _align_greedy(cand: Sequence[str], ref: Sequence[str],
                  synonyms=None) -> Tuple[int, int]:
    """Round-3 staged greedy scan (exact → stem → synonym, first-match in
    sentence order) — kept as the fallback when the exact search trips its
    node budget on adversarial inputs."""
    matched_ref = [False] * len(ref)
    matched_cand = [False] * len(cand)
    align: List[Tuple[int, int]] = []

    def run_stage(match) -> None:
        for i, cw in enumerate(cand):
            if matched_cand[i]:
                continue
            for j, rw in enumerate(ref):
                if matched_ref[j]:
                    continue
                if match(cw, rw):
                    align.append((i, j))
                    matched_cand[i] = True
                    matched_ref[j] = True
                    break

    run_stage(lambda c, r: c == r)
    run_stage(lambda c, r: _porter_stem(c) == _porter_stem(r))
    if synonyms is not None:
        run_stage(lambda c, r: r in synonyms(c))
    if not align:
        return 0, 0
    align.sort()
    chunks = 1
    for (i0, j0), (i1, j1) in zip(align, align[1:]):
        if not (i1 == i0 + 1 and j1 == j0 + 1):
            chunks += 1
    return len(align), chunks


def _meteor_align(cand: Sequence[str], ref: Sequence[str],
                  synonyms=None) -> Tuple[int, int]:
    """Chunk-minimizing METEOR alignment. Returns (#matches, #chunks).

    Exact search (``_align_exact``) with the Java scorer's resolution
    order — max matches, then min chunks, then min summed match distance —
    replacing round 3's greedy first-match scan whose duplicate-word
    tie-breaks diverged from the jar by up to 0.133 per pair
    (docs/METRICS.md). Falls back to the greedy scan only past the search
    budget (never on real captions)."""
    try:
        matches, chunks = _align_exact(_match_edges(cand, ref, synonyms))
    except _AlignBudget:
        return _align_greedy(cand, ref, synonyms)
    return matches, chunks


def meteor_lite(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]],
                alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5,
                synonyms=None) -> float:
    """METEOR with the standard parameters (alpha .9, beta 3, gamma .5).

    ``synonyms``: optional callable word → set of synonym lemma names.
    Defaults to the module-level table installed by :func:`set_wordnet_path`
    (``cfg.data.wordnet_path``) — the WordNet synonym stage lights up the
    moment WordNet data exists on disk; without it the scorer runs the
    exact + Porter-stem stages only (measured divergence vs nltk's METEOR
    in the same no-WordNet mode: see tests/test_metrics.py goldens)."""
    if synonyms is None:
        synonyms = _WORDNET_SYNONYMS
    scores = []
    for img_id, refs in gts.items():
        cand = res[img_id]
        best = 0.0
        for ref in refs:
            m, chunks = _meteor_align(cand, ref, synonyms)
            if m == 0:
                continue
            prec = m / len(cand)
            rec = m / len(ref)
            fmean = prec * rec / (alpha * prec + (1 - alpha) * rec)
            frag = chunks / m
            penalty = gamma * (frag ** beta)
            best = max(best, fmean * (1 - penalty))
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


# --------------------------------------------------------------------------
# WordNet synonym table (the Java METEOR's third match stage)
# --------------------------------------------------------------------------

_WORDNET_SYNONYMS = None  # module default, installed by set_wordnet_path


class _SynonymTable:
    """word → frozenset of synonym lemma names (incl. the word itself)."""

    def __init__(self, table: Dict[str, frozenset]):
        self.table = table
        self._empty = frozenset()

    def __call__(self, word: str) -> frozenset:
        return self.table.get(word, self._empty) or frozenset((word,))


def load_wordnet_synonyms(path: str) -> _SynonymTable:
    """Build the METEOR synonym table from WordNet data on disk.

    Accepts either a WordNet database directory (the standard ``index.pos``
    + ``data.pos`` files, e.g. nltk's ``corpora/wordnet``) or a plain-text
    synonym-group file (one group per line, whitespace/comma separated) for
    environments without the full database. The table maps each
    single-word lemma to the union of lemma names of all its synsets — the
    set the Java METEOR and nltk consult for the synonym match stage
    (reference metrics.py:16-39 reached it through pycocoevalcap's Java
    jar)."""
    table: Dict[str, set] = {}
    if os.path.isdir(path):
        poses = [("noun", "n"), ("verb", "v"), ("adj", "a"), ("adv", "r")]
        for name, _pos in poses:
            data_file = os.path.join(path, f"data.{name}")
            index_file = os.path.join(path, f"index.{name}")
            if not (os.path.exists(data_file) and os.path.exists(index_file)):
                continue
            synset_words: Dict[str, List[str]] = {}
            with open(data_file, encoding="utf-8") as f:
                for line in f:
                    if line.startswith("  ") or not line.strip():
                        continue
                    parts = line.split()
                    offset, w_cnt = parts[0], int(parts[3], 16)
                    words = [parts[4 + 2 * k].lower()
                             for k in range(w_cnt)]
                    # multiword collocations (underscored) are excluded,
                    # matching nltk's lemma.name().find('_') < 0 filter
                    synset_words[offset] = [w for w in words if "_" not in w]
            with open(index_file, encoding="utf-8") as f:
                for line in f:
                    if line.startswith("  ") or not line.strip():
                        continue
                    parts = line.split()
                    lemma, synset_cnt = parts[0].lower(), int(parts[2])
                    # a malformed/zero-count row must be rejected:
                    # parts[-0:] would be the WHOLE line, polluting the
                    # table with header fields as synset offsets
                    if "_" in lemma or synset_cnt <= 0:
                        continue
                    offs = parts[-synset_cnt:]
                    bucket = table.setdefault(lemma, {lemma})
                    for off in offs:
                        bucket.update(synset_words.get(off, ()))
    else:
        with open(path, encoding="utf-8") as f:
            for line in f:
                group = [w for w in re.split(r"[,\s]+", line.strip().lower())
                         if w]
                for w in group:
                    table.setdefault(w, {w}).update(group)
    return _SynonymTable({w: frozenset(s) for w, s in table.items()})


def set_wordnet_path(path: str) -> bool:
    """Install (or clear, with '') the module-default METEOR synonym table
    from ``path``. Returns True when a table is active. Wired to
    ``cfg.data.wordnet_path`` by the train/eval entry points."""
    global _WORDNET_SYNONYMS
    if not path:
        _WORDNET_SYNONYMS = None
        return False
    _WORDNET_SYNONYMS = load_wordnet_synonyms(path)
    return True


# --------------------------------------------------------------------------
# Entry points mirroring the reference API
# --------------------------------------------------------------------------

def evaluate_captions(outputs: List[dict],
                      annotations: Dict[str, List[str]]) -> Dict[str, float]:
    """Full COCO metric sweep over ``[{image_id, caption}]`` predictions.

    ``annotations`` maps image_id -> list of raw reference captions (the
    content of MSR_VTT.json for the split). Returns scores on the raw 0-1
    (or CIDEr 0-10) scale; callers x100 like the reference does.
    """
    res: Dict[str, List[str]] = {}
    gts: Dict[str, List[List[str]]] = {}
    for out in outputs:
        img_id = str(out["image_id"])
        if img_id not in annotations:
            continue
        res[img_id] = ptb_tokenize(out["caption"])
        gts[img_id] = [ptb_tokenize(c) for c in annotations[img_id]]
    if not res:
        return {}
    b = bleu(gts, res)
    return {
        "Bleu_1": b[0],
        "Bleu_2": b[1],
        "Bleu_3": b[2],
        "Bleu_4": b[3],
        "METEOR": meteor_lite(gts, res),
        "ROUGE_L": rouge_l(gts, res),
        "CIDEr": cider(gts, res),
    }


def load_coco_annotations(ann_file: str) -> Dict[str, List[str]]:
    """Parse a COCO-format annotation JSON into image_id -> captions."""
    with open(ann_file) as f:
        ann = json.load(f)
    table: Dict[str, List[str]] = defaultdict(list)
    for a in ann.get("annotations", []):
        table[str(a["image_id"])].append(a["caption"])
    return dict(table)


def calculate_score(outputs: List[dict], filepath: str, run_dir: str,
                    ann_file: str = "data/MSRVTT/annotation/MSR_VTT.json") -> Dict[str, float]:
    """Reference-faithful epoch-end sweep (reference metrics.py:16-39):
    dump preds JSON, score vs COCO annotations, x100, print + append to file.
    """
    os.makedirs(run_dir, exist_ok=True)
    res_file = os.path.join(run_dir, "validation_preds.json")
    with open(res_file, "w") as f:
        json.dump(outputs, f)
    with open(filepath, "a") as f:
        f.write("\n\n")
        f.write(json.dumps(outputs))

    annotations = load_coco_annotations(ann_file)
    raw = evaluate_captions(outputs, annotations)
    out = {}
    for metric, score in raw.items():
        out[metric] = score * 100
        print(f"{metric}: {score * 100}")
    with open(filepath, "a") as f:
        f.write("\n\n")
        f.write(json.dumps(out))
    return out


def calculate_bleu_score_corpus(references: List[List[str]],
                                candidates: List[str]) -> float:
    """Corpus BLEU-4 x100 on raw strings (reference metrics.py:42-68).

    The reference's tokenize loop was a no-op; here candidates/references are
    actually PTB-tokenized before scoring (bug fixed, documented).
    """
    assert len(references) == len(candidates), \
        "The lengths of references and candidates must be the same"
    assert isinstance(references, list) and isinstance(candidates, list)
    gts = {str(i): [ptb_tokenize(r) for r in refs]
           for i, refs in enumerate(references)}
    res = {str(i): ptb_tokenize(c) for i, c in enumerate(candidates)}
    return bleu(gts, res)[3] * 100

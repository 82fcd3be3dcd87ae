"""Task metrics: grounding (box parsing + IoU) and captioning (BLEU /
CIDEr) (the port's copy of lvv_tpu/train/metrics.py).

Host-side and numpy only:
- 7-D box extraction from generated text: regex over
  "[x, y, z, dx, dy, dz, yaw]"-style tuples, nested / multi-box answers
  supported;
- BEV / 3D IoU between parsed boxes: the exact rotated IoU, the two
  rectangles clipped against each other (Sutherland-Hodgman, as
  lvv_tpu/ops/boxes.py clips them);
- class-name extraction and top-1 accuracy;
- BLEU-4 and CIDEr natively; SPICE and BERTScore gate on their
  heavyweight dependencies and report None when unavailable;
- split-by-template aggregation.
"""
from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_NUM = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"
_BOX_RE = re.compile(r"[\[\(]\s*(" + _NUM + r")(?:\s*,\s*(" + _NUM + r")){6}"
                     r"\s*[\]\)]")
_TUPLE_RE = re.compile(r"[\[\(]([^\[\]\(\)]+)[\]\)]")


def extract_boxes(text: str) -> List[List[float]]:
    """All 7-number tuples in the text -> [N, 7] lists
    (reference metrics.py:8-46 extract_bboxes_from_text)."""
    out = []
    for m in _TUPLE_RE.finditer(text):
        nums = re.findall(_NUM, m.group(1))
        if len(nums) == 7:
            try:
                out.append([float(x) for x in nums])
            except ValueError:
                continue
    return out


NUSC_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
                "barrier", "motorcycle", "bicycle", "pedestrian",
                "traffic_cone")


def extract_class(text: str,
                  classes: Sequence[str] = NUSC_CLASSES) -> Optional[str]:
    """First class name mentioned (reference :129-147)."""
    low = text.lower().replace("_", " ")
    best = None
    best_pos = len(low) + 1
    for c in classes:
        pos = low.find(c.replace("_", " "))
        if 0 <= pos < best_pos:
            best, best_pos = c, pos
    return best


def _corners_bev(box) -> np.ndarray:
    """7-D box -> its 4 BEV corners [4, 2], counter-clockwise."""
    x, y, dx, dy, ang = box[0], box[1], box[3], box[4], box[6]
    c, s = math.cos(ang), math.sin(ang)
    lx = np.array([dx, -dx, -dx, dx]) * 0.5
    ly = np.array([dy, dy, -dy, -dy]) * 0.5
    return np.stack([lx * c - ly * s + x, lx * s + ly * c + y], axis=-1)


def _clip_halfplane(poly, p0, p1):
    """The part of polygon `poly` (a list of points) left of p0 -> p1: per
    edge, the crossing point where the edge crosses, then the vertex where
    it is inside."""
    edge = p1 - p0

    def side(q):
        return edge[0] * (q[1] - p0[1]) - edge[1] * (q[0] - p0[0])
    out = []
    for i, cur in enumerate(poly):
        prv = poly[i - 1]
        s_cur, s_prv = side(cur), side(prv)
        if (s_cur >= 0) != (s_prv >= 0):
            den = s_prv - s_cur
            t = s_prv / (den if abs(den) >= 1e-12 else 1e-12)
            out.append(prv + t * (cur - prv))
        if s_cur >= 0:
            out.append(cur)
    return out


def _overlap_bev(box_a, box_b) -> float:
    """Exact rotated BEV overlap area of two 7-D boxes."""
    poly = list(_corners_bev(box_a))
    cb = _corners_bev(box_b)
    for i in range(4):
        poly = _clip_halfplane(poly, cb[i], cb[(i + 1) % 4])
        if not poly:
            return 0.0
    if len(poly) < 3:
        return 0.0
    p = np.asarray(poly)
    nxt = np.roll(p, -1, axis=0)
    return 0.5 * abs(float(np.sum(p[:, 0] * nxt[:, 1] - nxt[:, 0] * p[:, 1])))


def bev_iou(box_a: Sequence[float], box_b: Sequence[float]) -> float:
    """Rotated BEV IoU between two 7-D boxes."""
    a, b = np.asarray(box_a, np.float64), np.asarray(box_b, np.float64)
    inter = _overlap_bev(a, b)
    return inter / max(a[3] * a[4] + b[3] * b[4] - inter, 1e-6)


def iou3d(box_a: Sequence[float], box_b: Sequence[float]) -> float:
    """Rotated 3D IoU: BEV overlap times z overlap over the union volume."""
    a, b = np.asarray(box_a, np.float64), np.asarray(box_b, np.float64)
    z_ov = max(min(a[2] + a[5] * 0.5, b[2] + b[5] * 0.5)
               - max(a[2] - a[5] * 0.5, b[2] - b[5] * 0.5), 0.0)
    inter = _overlap_bev(a, b) * z_ov
    return inter / max(a[3] * a[4] * a[5] + b[3] * b[4] * b[5] - inter, 1e-6)


# ---------------------------------------------------------------- captions

def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _tok(s: str) -> List[str]:
    return re.findall(r"\w+", s.lower())


def bleu4(candidates: Sequence[str], references: Sequence[str]) -> float:
    """Corpus BLEU-4 with brevity penalty (single reference per candidate)."""
    log_precisions = []
    for n in range(1, 5):
        match, total = 0, 0
        for c, r in zip(candidates, references):
            cg, rg = _ngrams(_tok(c), n), _ngrams(_tok(r), n)
            match += sum((cg & rg).values())
            total += max(sum(cg.values()), 0)
        if total == 0:
            continue  # all candidates shorter than n tokens: skip level
        if match == 0:
            if n == 1:
                return 0.0  # zero unigram overlap: nothing shared at all
            match = 0.5  # smoothing (NLTK method-1 style) for short corpora
        log_precisions.append(math.log(match / total))
    if not log_precisions:
        return 0.0
    c_len = sum(len(_tok(c)) for c in candidates)
    r_len = sum(len(_tok(r)) for r in references)
    bp = 1.0 if c_len > r_len else math.exp(1 - r_len / max(c_len, 1))
    return bp * math.exp(sum(log_precisions) / len(log_precisions))


def cider(candidates: Sequence[str], references: Sequence[str],
          n_max: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D (single reference; tf-idf over the reference corpus)."""
    if not candidates:
        return 0.0
    doc_freq = [Counter() for _ in range(n_max)]
    refs_tok = [_tok(r) for r in references]
    for rt in refs_tok:
        for n in range(n_max):
            for g in set(_ngrams(rt, n + 1)):
                doc_freq[n][g] += 1
    n_docs = max(len(references), 1)

    def tfidf(counter: Counter, n: int) -> Dict[tuple, float]:
        total = max(sum(counter.values()), 1)
        out = {}
        for g, cnt in counter.items():
            # add-one smoothing on the corpus size so single-reference
            # corpora (idf would be log(1)=0 exactly) still score > 0
            idf = math.log((n_docs + 1) / max(doc_freq[n][g], 1))
            out[g] = (cnt / total) * idf
        return out

    scores = []
    for c, rt in zip(candidates, refs_tok):
        ct = _tok(c)
        score = 0.0
        for n in range(n_max):
            cv = tfidf(_ngrams(ct, n + 1), n)
            rv = tfidf(_ngrams(rt, n + 1), n)
            num = sum(min(cv.get(g, 0.0), v) * v for g, v in rv.items())
            norm_c = math.sqrt(sum(v * v for v in cv.values()))
            norm_r = math.sqrt(sum(v * v for v in rv.values()))
            if norm_c > 0 and norm_r > 0:
                s = num / (norm_c * norm_r)
            else:
                s = 0.0
            delta = len(ct) - len(rt)
            s *= math.exp(-delta * delta / (2 * sigma ** 2))
            score += s
        scores.append(10.0 * score / n_max)
    return float(np.mean(scores))


def spice(candidates, references) -> Optional[float]:
    """SPICE F-score via pycocoevalcap's Java scene-graph scorer
    (reference metrics.py:150-219 wires Spice().compute_score over
    {id: [caption]} dicts). Returns None when the dependency (or its JVM)
    is absent — this environment ships neither."""
    try:
        from pycocoevalcap.spice.spice import Spice
    except Exception:
        return None
    gts = {i: [r] for i, r in enumerate(references)}
    res = {i: [c] for i, c in enumerate(candidates)}
    try:
        score, _ = Spice().compute_score(gts, res)
    except Exception:
        return None   # JVM missing / scorer crashed
    return float(score)


_SPICE_STOP = frozenset(
    "a an the is are was were be been being of to in on at by with for and "
    "or as it its this that these those there here from into over under "
    "near up down out off very so too i you he she we they".split())
_SPICE_ATTRS = frozenset(
    "red green blue yellow black white gray grey orange brown large small "
    "big little tall short long wide narrow fast slow parked moving "
    "stationary left right front back rear close far distant near new old "
    "two three four five several many few one".split())


def _spice_lite_tuples(text: str):
    """Approximate scene-graph tuples from one caption: objects (stemmed
    content unigrams), attribute-object pairs (an attribute lexicon word
    attached to the next object, skipping intervening attributes — "a
    large red car" yields both (large, car) and (red, car)), and
    object-relation-object triples (object, connective, next object).
    Gerunds ("riding", "crossing") count as relations, not objects — the
    delta vs hand-derived official SPICE on relation-bearing fixtures
    halved with this (benchmarks/spice_delta.json)."""
    toks = [t for t in "".join(ch.lower() if ch.isalnum() else " "
                               for ch in text).split() if t]

    def stem(t):
        return t[:-1] if len(t) > 3 and t.endswith("s") else t

    def is_rel(t):
        return len(t) > 4 and t.endswith("ing")

    content = [(i, stem(t)) for i, t in enumerate(toks)
               if t not in _SPICE_STOP]
    objs = [(i, t) for i, t in content
            if t not in _SPICE_ATTRS and not is_rel(t)]
    obj_pos = {i for i, _ in objs}
    tuples = {("o", t) for _, t in objs}
    for i, t in content:
        if t in _SPICE_ATTRS:
            # attach to the next object, skipping other attributes
            for j in range(i + 1, len(toks)):
                if j in obj_pos:
                    tuples.add(("a", t, stem(toks[j])))
                    break
                if stem(toks[j]) not in _SPICE_ATTRS \
                        and toks[j] not in _SPICE_STOP:
                    break
    for (i1, t1), (i2, t2) in zip(objs, objs[1:]):
        between = [stem(t) for t in toks[i1 + 1:i2]
                   if t not in _SPICE_STOP and stem(t) not in _SPICE_ATTRS]
        if between:
            tuples.add(("r", t1, between[0], t2))
    return tuples


def spice_lite(candidates, references) -> float:
    """Pure-python SPICE substitute: the SPICE F-score formula (tuple-set
    F1, Anderson et al. 2016 eq. 1-3; reference metrics.py:150-219 runs
    the Java scene-graph version) over heuristically extracted tuples.

    Documented delta vs real SPICE: tuples come from a lexicon/adjacency
    heuristic instead of a dependency parse, and matching is exact-stem
    (no WordNet synonym sets). Scores are therefore NOT comparable in
    absolute value to published SPICE numbers, but rank captions with the
    same propositional-overlap signal; the dashboard labels this
    `spice_lite`, never `spice`."""
    f1s = []
    for c, r in zip(candidates, references):
        ct, rt = _spice_lite_tuples(c), _spice_lite_tuples(r)
        inter = len(ct & rt)
        p = inter / len(ct) if ct else 0.0
        rec = inter / len(rt) if rt else 0.0
        f1s.append(0.0 if p + rec == 0 else 2 * p * rec / (p + rec))
    return float(np.mean(f1s)) if f1s else 0.0


def bertscore(candidates, references,
              model_path: Optional[str] = None) -> Optional[float]:
    """BERTScore F1. Prefers the `bert_score` package (reference
    metrics.py:150-219); falls back to a native transformers
    implementation — greedy token-embedding cosine matching (the
    BERTScore definition) over a LOCAL model given via `model_path` or
    $LVV_BERTSCORE_MODEL (zero-egress: nothing is downloaded). None when
    neither path is available."""
    try:
        import bert_score
        p, r, f1 = bert_score.score(list(candidates), list(references),
                                    lang="en", verbose=False)
        return float(f1.mean())
    except Exception:
        pass
    import os
    model_path = model_path or os.environ.get("LVV_BERTSCORE_MODEL")
    if not model_path or not os.path.isdir(model_path):
        return None
    try:
        import torch
        from transformers import AutoModel, AutoTokenizer
        tok = AutoTokenizer.from_pretrained(model_path)
        mdl = AutoModel.from_pretrained(model_path)
        mdl.eval()

        def embed(texts):
            enc = tok(list(texts), return_tensors="pt", padding=True,
                      truncation=True, max_length=128)
            with torch.no_grad():
                h = mdl(**enc).last_hidden_state
            h = torch.nn.functional.normalize(h, dim=-1)
            return h, enc["attention_mask"].bool()

        ch, cm = embed(candidates)
        rh, rm = embed(references)
        f1s = []
        for i in range(len(candidates)):
            sim = ch[i][cm[i]] @ rh[i][rm[i]].T       # [Tc, Tr]
            if sim.numel() == 0:
                f1s.append(0.0)
                continue
            p = float(sim.max(dim=1).values.mean())
            r = float(sim.max(dim=0).values.mean())
            f1s.append(0.0 if p + r == 0 else 2 * p * r / (p + r))
        return float(np.mean(f1s))
    except Exception:
        return None


# ------------------------------------------------------------- aggregation

def caption_metrics(cands: Sequence[str], refs: Sequence[str]) -> Dict:
    return {"bleu4": bleu4(cands, refs), "cider": cider(cands, refs),
            "spice": spice(cands, refs),
            # always-available propositional-overlap proxy (see spice_lite
            # docstring for the delta vs the Java scorer)
            "spice_lite": spice_lite(cands, refs),
            "bertscore": bertscore(cands, refs),
            "n": len(cands)}


def grounding_metrics(pred_texts: Sequence[str],
                      ref_texts: Sequence[str]) -> Dict:
    """Top-1 class accuracy + mean best-pair BEV/3D IoU
    (reference :222-303)."""
    cls_hits, ious_bev, ious_3d, n_box = 0, [], [], 0
    for p, r in zip(pred_texts, ref_texts):
        pc, rc = extract_class(p), extract_class(r)
        if rc is not None and pc == rc:
            cls_hits += 1
        pb, rb = extract_boxes(p), extract_boxes(r)
        if pb and rb:
            n_box += 1
            best_bev = max(bev_iou(a, b) for a in pb for b in rb)
            best_3d = max(iou3d(a, b) for a in pb for b in rb)
            ious_bev.append(best_bev)
            ious_3d.append(best_3d)
    n = max(len(pred_texts), 1)
    return {"top1_class_acc": cls_hits / n,
            "bev_iou": float(np.mean(ious_bev)) if ious_bev else 0.0,
            "iou_3d": float(np.mean(ious_3d)) if ious_3d else 0.0,
            "n": len(pred_texts), "n_with_boxes": n_box}


def metrics_by_template(preds: Sequence[str], refs: Sequence[str],
                        templates: Sequence[str]) -> Dict[str, Dict]:
    """Split caption vs grounding rows and aggregate per type
    (reference :307-347)."""
    groups: Dict[str, List[int]] = defaultdict(list)
    for i, t in enumerate(templates):
        groups["grounding" if t == "det_area" else "caption"].append(i)
    out: Dict[str, Dict] = {}
    if groups.get("caption"):
        idx = groups["caption"]
        out["caption"] = caption_metrics([preds[i] for i in idx],
                                         [refs[i] for i in idx])
    if groups.get("grounding"):
        idx = groups["grounding"]
        out["grounding"] = grounding_metrics([preds[i] for i in idx],
                                             [refs[i] for i in idx])
    return out

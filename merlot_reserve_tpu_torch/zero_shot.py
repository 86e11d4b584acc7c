"""Zero-shot inference: mask-infilling ranking and batched MASK features,
the library core behind the demos and the zero-shot scripts (the JAX
package's ``zero_shot.py``).

The model is a ``models.model.PretrainedMerlotReserve``; it runs where its
weights are (the card unless it was built on the CPU). Scores are taken in
f32 from the model's embeddings, and returned as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from merlot_reserve_tpu_torch.tokenizer import MASK

_EMBED_FIELDS = ("images", "audio_clips", "tokens", "subseg_idxs")


def rank_options(model, video_pre: Dict, options: Sequence[str],
                 temperature: float = 100.0) -> np.ndarray:
    """Embed one preprocessed video and rank ``options`` at each MASK position.

    :param model: PretrainedMerlotReserve
    :param video_pre: ``preprocess.preprocess_video`` output
    :return: [num_masks, num_options] probabilities
    """
    out_h = model.embed_video(*(np.asarray(video_pre[k]) for k in _EMBED_FIELDS))
    out_h = out_h[torch.from_numpy(np.asarray(video_pre["tokens"]) == MASK).to(out_h.device)]
    label_space = model.get_label_space(list(options))
    logits = temperature * (out_h.float() @ label_space.float().T)
    return torch.softmax(logits, -1).cpu().numpy()


def extract_mask_features(model, video_pres: List[Dict]) -> np.ndarray:
    """Batch-embed videos and return the hidden state at the first MASK of
    each, [N, H] f32. All videos must share shapes; only the embedding
    inputs are stacked (the dicts may carry other fields)."""
    batch = [np.stack([np.asarray(v[k]) for v in video_pres]) for k in _EMBED_FIELDS]
    out = model.batch_embed_video(*batch)
    mask_pos = [int(np.argmax(np.asarray(vp["tokens"]) == MASK)) for vp in video_pres]
    return out[torch.arange(len(video_pres)), torch.tensor(mask_pos)].float().cpu().numpy()


def score_label_space(model, mask_features: np.ndarray, options: Sequence[str],
                      temperature: float = 100.0) -> np.ndarray:
    """[N, H] precomputed MASK features x label space -> [N, num_options]
    logits."""
    label_space = model.get_label_space(list(options)).float()
    feats = torch.as_tensor(np.asarray(mask_features, np.float32), device=label_space.device)
    return (temperature * (feats @ label_space.T)).cpu().numpy()


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, ks=(1, 5)) -> Dict[str, float]:
    """Top-k accuracies (zero_shot_eval_ek100.py metric surface)."""
    order = np.argsort(-logits, axis=-1)
    out = {}
    for k in ks:
        hit = (order[:, :k] == labels[:, None]).any(-1)
        out[f"top{k}"] = float(hit.mean())
    return out


def verb_noun_action_accuracy(logits: np.ndarray, labels: np.ndarray,
                              action_to_verb: np.ndarray,
                              action_to_noun: np.ndarray,
                              ks=(1, 5)) -> Dict[str, float]:
    """EK-100 style: action logits are over 'verb noun' strings; verb/noun
    accuracy marginalizes over the other factor by max."""
    out = {}
    for name, mapping in [("action", None), ("verb", action_to_verb),
                          ("noun", action_to_noun)]:
        if mapping is None:
            lg, lb = logits, labels
        else:
            n_classes = int(mapping.max()) + 1
            lg = np.full((logits.shape[0], n_classes), -1e9, logits.dtype)
            np.maximum.at(lg.T, mapping, logits.T)
            lb = mapping[labels]
        for k, v in topk_accuracy(lg, lb, ks).items():
            out[f"{name}_{k}"] = v
    return out


_WARNED_HEURISTIC_REWRITE = False


def statement_for_qa_item(item: dict, answer_slot: str = "<|MASK|>") -> str:
    """Pick the mask-infill statement for one MSRVTT-QA-style item.

    Priority: an explicit ``statement`` field; then a ``question`` that
    already carries the answer slot — the reference's ``{split}_infill.json``
    format, where qa_to_infill.py writes its GPT-3 rewrite back into
    ``question`` with ``_`` -> ``<|MASK|>`` (qa_to_infill.py:59-63), so
    precomputed reference rewrites are consumed verbatim for
    benchmark-comparable accuracy; finally the heuristic
    :func:`question_to_statement` fallback (which warns: NOT comparable)."""
    if item.get("statement"):
        return item["statement"]
    if answer_slot in item["question"]:
        return item["question"]
    return question_to_statement(item["question"], answer_slot)


def question_to_statement(question: str, answer_slot: str = "<|MASK|>") -> str:
    """Heuristic question->statement rewrite for mask infilling.

    WARNING: the reference produced its MSRVTT-QA numbers with offline
    GPT-3 rewrites (qa_to_infill.py); this 5-template fallback is NOT
    comparable — accuracy measured through it will differ from published
    MSRVTT-QA results. Supply your own rewrites for benchmark parity."""
    global _WARNED_HEURISTIC_REWRITE
    if not _WARNED_HEURISTIC_REWRITE:
        import warnings

        warnings.warn(
            "question_to_statement uses a heuristic template rewrite; the "
            "reference's MSRVTT-QA numbers used offline GPT-3 rewrites "
            "(qa_to_infill.py) — accuracies are NOT comparable. Supply your "
            "own statement rewrites for benchmark parity.")
        _WARNED_HEURISTIC_REWRITE = True
    q = question.strip().rstrip("?").lower()
    for prefix, template in [
        ("what is ", "{rest} is " + answer_slot),
        ("what are ", "{rest} are " + answer_slot),
        ("what color is ", "{rest} is " + answer_slot),
        ("what colour is ", "{rest} is " + answer_slot),
        ("who is ", "{rest} is " + answer_slot),
        ("who are ", "{rest} are " + answer_slot),
        ("where is ", "{rest} is in " + answer_slot),
        ("where are ", "{rest} are in " + answer_slot),
        ("when is ", "{rest} is at " + answer_slot),
        ("how many ", "there are " + answer_slot + " {rest}"),
    ]:
        if q.startswith(prefix):
            return template.format(rest=q[len(prefix):])
    return q + " " + answer_slot

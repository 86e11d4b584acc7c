"""Zero-shot inference: mask-infilling ranking, batched MASK features and
batched zero-shot QA over VCR and TVQA records, the library core behind
the demos and the zero-shot scripts (the JAX package's ``zero_shot.py``).

The model is a ``models.model.PretrainedMerlotReserve``; it runs where its
weights are (the card unless it was built on the CPU). Scores are taken in
f32 from the model's embeddings, and returned as numpy arrays.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
from merlot_reserve_tpu_torch.parallel import comm
from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, batch_axes
from merlot_reserve_tpu_torch.parallel.sharding import data_shard
from merlot_reserve_tpu_torch.tokenizer import MASK
from merlot_reserve_tpu_torch.utils.weights import load_flax_params

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


def _local_batch_rows(mesh, n: int) -> np.ndarray:
    """The positions, ascending, of this process's rows in a global batch of
    ``n`` rows: its contiguous share over the batch axes of a process mesh
    (the JAX package's ``_local_batch_rows``), or all of them."""
    index, count = data_shard(mesh)
    if n % count:
        raise ValueError(f"a batch of {n} rows does not split over {count} data-parallel ranks")
    k = n // count
    return np.arange(index * k, (index + 1) * k)


@torch.no_grad()
def zero_shot_qa_eval(model, params, batches, task: str, temperature: float = 100.0,
                      mesh=None) -> Tuple[Dict[str, float], List[Dict]]:
    """Batched zero-shot TVQA or VCR evaluation.

    :param model: ``finetune.models.MerlotReserveTVQAZeroShot`` or
        ``MerlotReserveVCRZeroShot``, on the device it runs on
    :param params: a flax parameter tree (a pretrained checkpoint's), loaded
        into ``model`` once (its subtrees for towers the model lacks are
        ignored, as flax's ``apply`` ignores unused parameters); None to run
        with the weights ``model`` holds. They stay on the device across
        batches
    :param batches: ``(ids, batch)`` pairs from ``finetune.data.finetune_batches(...,
        task='{tvqa,vcr}_zero_shot', return_ids=True, repeat=False)``; rows
        whose id is 'pad' are skipped
    :param task: 'tvqa' (audio and text streams; 'joint' ranks the sum of
        their softmaxes) or 'vcr' (the qa and qar tasks; 'joint' is right
        when both are)
    :param mesh: run every batch under ``activate_mesh(mesh)``; under a
        process mesh each data-parallel rank ranks its rows of every
        (global) batch (``_local_batch_rows``), and the hits and counts are
        summed over the ranks
    :return: (metrics {'acc_<name>': mean, 'n': rows}, one row per example:
        {'id', 'pred_<name>'}, every rank's in the batches' order)
    """
    if params is not None:
        load_flax_params(model, {k: v for k, v in params.items() if hasattr(model, k)})
    device = next(model.parameters()).device
    rows, hits = [], []
    sharded = mesh is not None and mesh.is_process_mesh
    order = []
    with activate_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for b, (ids, batch) in enumerate(batches):
            mine = _local_batch_rows(mesh if sharded else None, len(ids))
            if sharded:
                ids = [ids[i] for i in mine]
                batch = {k: np.asarray(v)[mine] for k, v in batch.items()}
            out = model(batch_to_tensors({k: v for k, v in batch.items() if k != "labels"},
                                         device))
            if task == "tvqa":
                la, lt = (x.float().cpu() * temperature for x in out)
                joint = torch.softmax(la, -1) + torch.softmax(lt, -1)
                preds = {"audio": la.argmax(-1), "text": lt.argmax(-1),
                         "joint": joint.argmax(-1)}
            else:
                lg = out.float().cpu()  # [B, 2, num_answers]
                preds = {"qa": lg[:, 0].argmax(-1), "qar": lg[:, 1].argmax(-1)}
            preds = {k: v.numpy() for k, v in preds.items()}
            labels = np.asarray(batch["labels"])
            for i, ex_id in enumerate(ids):
                if ex_id == "pad":
                    continue
                row, hit = {"id": ex_id}, {}
                for name, p in preds.items():
                    row[f"pred_{name}"] = int(p[i])
                    lab = labels[i] if labels.ndim == 1 else labels[i, 0 if name == "qa" else 1]
                    hit[name] = float(p[i] == lab)
                if task == "vcr":
                    hit["joint"] = hit["qa"] * hit["qar"]
                rows.append(row)
                hits.append(hit)
                order.append((b, int(mine[i])))
    if sharded:
        parts = comm.all_gather_object((order, rows, hits), mesh, batch_axes(mesh),
                                       what="metrics")
        merged = sorted(((o, r, h) for p in parts for o, r, h in zip(*p)), key=lambda t: t[0])
        rows, hits = [r for _, r, _ in merged], [h for _, _, h in merged]
    metrics = {f"acc_{k}": float(np.mean([h[k] for h in hits])) for k in hits[0]} if hits else {}
    metrics["n"] = len(hits)
    return metrics, rows


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

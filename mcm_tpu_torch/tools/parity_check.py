"""Numerical parity of the port against HF ``transformers``' CLIP.

    python -m mcm_tpu_torch.tools.parity_check record --hf-dir <snapshot> \\
        --out goldens_b16.npz --device cpu
    python -m mcm_tpu_torch.tools.parity_check check --goldens goldens_b16.npz \\
        [--ckpt ViT-B/16] [--ckpt-dir checkpoints] [--precision parity]
    python -m mcm_tpu_torch.tools.parity_check record-synth --config b16 \\
        --out clip_synth_b16.npz --device cpu
    python -m mcm_tpu_torch.tools.parity_check full-report \\
        --ckpt-dir checkpoints [--id-tree <tree> [--ood-tree <tree>]] --device cpu

The port of ``tools/parity_check.py``, all four modes, sharing its golden
format and its gates:

* ``record`` — HF's ``CLIPModel`` from a snapshot on the deterministic
  probe inputs (:func:`~mcm_tpu_torch.models.hf_synth.probe_inputs`): image
  and text features and MCM scores into an ``.npz``.
* ``record-synth`` — per-layer goldens of a synthesized HF state dict
  (:func:`~mcm_tpu_torch.models.hf_synth.synth_hf_clip_state_dict`) run
  through a real HF ``CLIPModel``.  ``--out`` is required: the JAX tool
  writes into ``tests/goldens/`` by default, and the committed goldens are
  the JAX package's files.
* ``check`` — the port's towers (``models/clip.py``) on the weights
  ``models/convert.py::resolve_clip_params`` finds, against a ``record``
  golden: max relative error of the features and scores under 1e-3 when
  the resolved precision is fp32, 3e-2 otherwise.
* ``full-report`` — one command from an HF snapshot directory to
  ``PARITY_REPORT.md``: tokenizer ids (5 fixed + 200 fuzz strings), per-layer
  activations (1e-3), per-image MCM through both pipelines on an image tree
  (5e-5) and AUROC on an ID/OOD pair (|Δ| < 0.1 pp), then
  ``**OVERALL: PASS|FAIL**``.

``record``, ``record-synth`` and ``full-report`` run HF's model and so need
``transformers``, imported inside them; the card host has none, so they run
where it is installed (``--device cpu``).  ``check`` and
:func:`hold_golden` need only the port: on the card they hold the port
against the committed goldens that HF recorded.  Every mode takes
``--device`` (default ``cuda``, which raises without a card), prints one
JSON line and exits 1 when its gate fails; :func:`main` returns the line's
dict.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mcm_tpu_torch.config import (CLIP_CONFIGS, HF_CKPT_MAPPING, Precision,
                                  apply_matmul_policy, resolve_device,
                                  resolve_precision)
from mcm_tpu_torch.data.transforms import (CLIP_MEAN, CLIP_STD,
                                           load_image_uint8,
                                           normalize_on_device)
from mcm_tpu_torch.metrics import get_measures
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models.convert import (convert_hf_clip, from_jax_params,
                                          resolve_clip_params)
from mcm_tpu_torch.models.hf_synth import (build_hf_clip, golden_config,
                                           golden_probe_inputs, probe_inputs,
                                           synth_hf_clip_state_dict,
                                           synth_scale_config)
from mcm_tpu_torch.scores import compute_scores, l2_normalize
from mcm_tpu_torch.text.tokenizer import CLIPTokenizer

CKPTS = ["ViT-B/32", "ViT-B/16", "ViT-L/14"]
GOLDEN_SLICE = 48  # per-layer hiddens are stored for the first 48 tokens
FUZZ_TEXTS = 200

#: tolerances (the JAX tool's and ``tests/test_golden_parity.py``'s)
CHECK_TOL_FP32, CHECK_TOL_FAST = 1e-3, 3e-2
LAYER_TOL = 1e-3
SCORE_TOL = 5e-5
AUROC_TOL_PP = 0.1
GOLDEN_REL_TOL, GOLDEN_MCM_ATOL = 5e-4, 1e-5


def _mcm_host(img: np.ndarray, txt: np.ndarray) -> np.ndarray:
    """MCM at T = 1 in numpy, as the recorders compute it."""
    imgn = img / np.linalg.norm(img, axis=-1, keepdims=True)
    txtn = txt / np.linalg.norm(txt, axis=-1, keepdims=True)
    logits = imgn @ txtn.T
    e = np.exp(logits - logits.max(1, keepdims=True))
    return -(e / e.sum(1, keepdims=True)).max(1)


def max_rel(ours, ref) -> float:
    """Largest |ours − ref| over the largest |ref|."""
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(ours, np.float32) - ref).max()
                 / (np.abs(ref).max() + 1e-12))


def _hf_model(hf_dir: str, device: torch.device):
    import transformers

    model = transformers.CLIPModel.from_pretrained(hf_dir)
    return model.to(device).eval()


def _hf_features(model, pixels, ids, mask, device, hidden: bool = False):
    """HF's image and text features (and per-layer hiddens) as numpy."""
    def t(a):
        return torch.from_numpy(a).to(device)

    with torch.no_grad():
        img = model.get_image_features(pixel_values=t(pixels))
        txt = model.get_text_features(input_ids=t(ids),
                                      attention_mask=t(mask))
        out = [img.float().cpu().numpy(), txt.float().cpu().numpy()]
        if hidden:
            vout = model.vision_model(pixel_values=t(pixels),
                                      output_hidden_states=True)
            tout = model.text_model(input_ids=t(ids), attention_mask=t(mask),
                                    output_hidden_states=True)
            out += [[h.float().cpu().numpy() for h in vout.hidden_states],
                    [h.float().cpu().numpy() for h in tout.hidden_states]]
    return out


def _reference_device(device: str) -> torch.device:
    """The device HF's model runs on, in true fp32 (no TF32) on a card."""
    dev = resolve_device(device)
    apply_matmul_policy(Precision.parity())
    return dev


def record(args) -> dict:
    dev = _reference_device(args.device)
    model = _hf_model(args.hf_dir, dev)
    pixels, ids, mask = probe_inputs()
    img, txt = _hf_features(model, pixels, ids, mask, dev)
    mcm = _mcm_host(img, txt)
    np.savez(args.out, image_features=img, text_features=txt, mcm=mcm,
             ckpt=args.ckpt)
    print(f"recorded goldens for {args.ckpt} -> {args.out}")
    return {"out": args.out, "ckpt": args.ckpt, "ok": True}


def record_synth(args) -> dict:
    """Per-layer goldens of the synthesized model at ``--config`` through
    the real HF ``CLIPModel``, into ``--out``."""
    import transformers

    dev = _reference_device(args.device)
    cfg = (golden_config() if args.config == "golden"
           else synth_scale_config(args.config))
    model = build_hf_clip(cfg, synth_hf_clip_state_dict(cfg, seed=args.seed))
    model = model.to(dev)
    pixels, ids, mask = golden_probe_inputs(cfg)
    img, txt, vhs, ths = _hf_features(model, pixels, ids, mask, dev,
                                      hidden=True)
    # a strided subset of hidden layers (always the embeddings and the
    # last) keeps the file a few MB at L/14
    v_idx = sorted(set(range(0, cfg.vision.layers + 1, args.layer_stride))
                   | {cfg.vision.layers})
    t_idx = sorted(set(range(0, cfg.text.layers + 1, args.layer_stride))
                   | {cfg.text.layers})
    vh = np.stack([vhs[i][:, :GOLDEN_SLICE] for i in v_idx])
    th = np.stack([ths[i][:, :GOLDEN_SLICE] for i in t_idx])
    np.savez_compressed(
        args.out, vision_hiddens=vh, text_hiddens=th,
        vision_layer_idx=np.asarray(v_idx), text_layer_idx=np.asarray(t_idx),
        image_features=img, text_features=txt, mcm=_mcm_host(img, txt),
        seed=args.seed, config=args.config, slice=GOLDEN_SLICE,
        transformers_version=str(transformers.__version__))
    print(f"recorded synth goldens (config {args.config}, seed {args.seed})"
          f" -> {args.out}: vision_hiddens {vh.shape} @layers {v_idx}, "
          f"text_hiddens {th.shape} @layers {t_idx}")
    return {"out": args.out, "config": args.config, "seed": args.seed,
            "vision_layers": v_idx, "text_layers": t_idx, "ok": True}


def _encode(model, cfg, pixels, ids, mask, precision: Precision,
            device: torch.device, collect_hidden: bool = False):
    """The port's image and text features (and hiddens) on the probe
    inputs, as fp32 numpy."""
    with torch.inference_mode():
        img = tclip.encode_image(model, cfg.vision,
                                 torch.from_numpy(pixels).to(device),
                                 precision, collect_hidden=collect_hidden)
        txt = tclip.encode_text(model, cfg.text,
                                torch.from_numpy(ids).to(device),
                                torch.from_numpy(mask).to(device),
                                precision, collect_hidden=collect_hidden)
    if collect_hidden:
        (img, vh), (txt, th) = img, txt
        return [x.float().cpu().numpy() for x in (img, txt, vh, th)]
    return [x.float().cpu().numpy() for x in (img, txt)]


def _port_mcm(img: np.ndarray, txt: np.ndarray) -> np.ndarray:
    """``compute_scores(img, l2_normalize(txt), "MCM")`` on the host."""
    return compute_scores(torch.from_numpy(img),
                          l2_normalize(torch.from_numpy(txt)),
                          score="MCM").numpy()


def check(args) -> dict:
    dev = resolve_device(args.device)
    gold = np.load(args.goldens, allow_pickle=True)
    if "ckpt" in gold and str(gold["ckpt"]) != args.ckpt:
        raise SystemExit(f"goldens were recorded for {gold['ckpt']}, not "
                         f"{args.ckpt} — a numeric FAIL against the wrong "
                         f"model would be meaningless")
    cfg = CLIP_CONFIGS[args.ckpt]()
    params = resolve_clip_params(args.ckpt, args.ckpt_dir)
    if params is None:
        raise SystemExit(f"no weights for {args.ckpt} under "
                         f"{args.ckpt_dir or 'checkpoints'}")
    precision = resolve_precision(args.precision)
    apply_matmul_policy(precision)
    model = from_jax_params(params, dev, precision.activation_dtype)
    pixels, ids, mask = probe_inputs()
    img, txt = _encode(model, cfg, pixels, ids, mask, precision, dev)
    mcm = _port_mcm(img, txt)

    def report(name, ours, ref):
        err = np.abs(ours - ref)
        rel = max_rel(ours, ref)
        print(f"{name:>16}: max abs {err.max():.3e}  mean abs "
              f"{err.mean():.3e}  max rel {rel:.3e}")
        return rel

    rels = {"image_features": report("image features", img,
                                     gold["image_features"]),
            "text_features": report("text features", txt,
                                    gold["text_features"]),
            "mcm": report("MCM scores", mcm, gold["mcm"])}
    # keyed off the RESOLVED policy: every fp32 alias gets the strict bound
    tol = (CHECK_TOL_FP32 if precision.activation_dtype == torch.float32
           else CHECK_TOL_FAST)
    ok = max(rels.values()) < tol
    print("PARITY:", "PASS" if ok else "FAIL", f"(tol {tol})")
    return {"ckpt": args.ckpt, "precision": args.precision,
            "max_rel": rels, "tol": tol, "ok": ok}


def hold_golden(gold_path: str, params=None, device="cuda",
                precision: Precision = Precision.parity(),
                hidden: bool = True) -> dict:
    """The port's towers against a ``record-synth`` golden, as
    ``tests/test_golden_parity.py`` holds JAX's: ``params`` (the converted
    tree; by default the golden's synthesized state dict converted here)
    on ``device`` in ``precision``, on the golden's probe inputs.  Returns
    each recorded layer's max relative error (``hidden``), the features'
    and the MCM scores' largest |Δ|, the bounds and ``ok``: every error
    under 5e-4 and MCM within 1e-5 in fp32; features and MCM under
    ``check``'s 3e-2 otherwise."""
    dev = resolve_device(device)
    gold = np.load(gold_path)
    name = str(gold["config"]) if "config" in gold.files else "golden"
    cfg = golden_config() if name == "golden" else synth_scale_config(name)
    if params is None:
        params = convert_hf_clip(
            synth_hf_clip_state_dict(cfg, seed=int(gold["seed"])), cfg)
    apply_matmul_policy(precision)
    model = from_jax_params(params, dev, precision.activation_dtype)
    del params
    pixels, ids, mask = golden_probe_inputs(cfg)
    t0 = time.perf_counter()
    out = _encode(model, cfg, pixels, ids, mask, precision, dev,
                  collect_hidden=hidden)
    wall = time.perf_counter() - t0
    del model
    img, txt = out[:2]
    fp32 = precision.activation_dtype == torch.float32
    tol = GOLDEN_REL_TOL if fp32 else CHECK_TOL_FAST
    row = {"config": name, "precision": "parity" if fp32 else "fast",
           "encode_s": wall,
           "image_features_max_rel": max_rel(img, gold["image_features"]),
           "text_features_max_rel": max_rel(txt, gold["text_features"]),
           "mcm_max_abs": float(np.abs(_mcm_host(img, txt)
                                       - gold["mcm"]).max()),
           "tol": tol, "mcm_atol": GOLDEN_MCM_ATOL if fp32 else None}
    worst = [row["image_features_max_rel"], row["text_features_max_rel"]]
    if hidden:
        s = int(gold["slice"])
        for tower, hs in (("vision", out[2]), ("text", out[3])):
            ref = gold[f"{tower}_hiddens"]
            idx = [int(i) for i in gold[f"{tower}_layer_idx"]]
            if hs.shape[0] - 1 != idx[-1]:
                raise RuntimeError(f"{tower}: {hs.shape[0] - 1} layers, the "
                                   f"golden's last is {idx[-1]}")
            rels = {layer: max_rel(hs[layer, :, :s], ref[r])
                    for r, layer in enumerate(idx)}
            row[f"{tower}_hidden_max_rel"] = rels
            worst += list(rels.values())
    ok = max(worst) < tol
    if fp32:
        ok = ok and row["mcm_max_abs"] <= GOLDEN_MCM_ATOL
    else:
        ok = ok and max_rel(_mcm_host(img, txt), gold["mcm"]) < tol
    row["ok"] = bool(ok)
    return row


def _tokenizer_report(hf_dir: str, ckpt_dir: str, lines: List[str]) -> bool:
    import transformers

    hf = transformers.CLIPTokenizer.from_pretrained(hf_dir)
    ours = CLIPTokenizer.resolve(ckpt_dir)
    if ours is None:
        lines.append("## Tokenizer\n\nFAIL: no vocab.json/merges.txt "
                     "resolvable from the checkpoint dir\n")
        return False
    rnd = random.Random(0)
    battery = ["a photo of a cat", "a photo of a Great White Shark.",
               "it's   the cat's photo, isn't it?", "café naïve — ok",
               "CAT!! 12 photos"]
    alphabet = ("abcdefghijklmnopqrstuvwxyz  .,!?'-0123456789"
                "ABCDEFGHIJé中文")
    battery += ["".join(rnd.choice(alphabet)
                        for _ in range(rnd.randrange(1, 40)))
                for _ in range(FUZZ_TEXTS)]
    bad = 0
    for t in battery:
        ref = hf([t], padding=True)
        got_ids, got_mask = ours([t], pad_to_multiple=1)
        if (list(got_ids[0]) != ref["input_ids"][0]
                or list(got_mask[0]) != ref["attention_mask"][0]):
            bad += 1
    ok = bad == 0
    lines.append(f"## Tokenizer\n\n{len(battery)} cases (fixed battery + "
                 f"{FUZZ_TEXTS} fuzz strings) vs HF `CLIPTokenizer`: "
                 f"**{bad} mismatches** — {'PASS' if ok else 'FAIL'}\n")
    return ok


def _tree_paths(tree: str, max_images: int):
    classes = sorted(e.name for e in os.scandir(tree) if e.is_dir())
    paths = []
    for cls in classes:
        for r, _, fnames in sorted(os.walk(os.path.join(tree, cls))):
            paths.extend(os.path.join(r, f) for f in sorted(fnames))
    return paths[:max_images], classes


def _score_tree_both(tree: str, model, hf_dir: str, ours, cfg, tokenizer,
                     max_images: int, device: torch.device):
    """(HF scores, port scores): MCM over the tree's own class prompts, each
    image decoded once by the PIL-exact host path and fed to both models."""
    import transformers

    paths, classes = _tree_paths(tree, max_images)
    imgs = np.stack([load_image_uint8(p) for p in paths])   # [N,H,W,3] u8
    prompts = [f"a photo of a {c}" for c in classes]

    mean = np.asarray(CLIP_MEAN, np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(CLIP_STD, np.float32).reshape(1, 3, 1, 1)
    pix = (imgs.transpose(0, 3, 1, 2).astype(np.float32) / 255.0
           - mean) / std
    enc = transformers.CLIPTokenizer.from_pretrained(hf_dir)(
        prompts, padding=True, return_tensors="pt")
    with torch.no_grad():
        img_f = model.get_image_features(
            pixel_values=torch.from_numpy(pix).to(device)).float().cpu()
        txt_f = model.get_text_features(
            input_ids=enc["input_ids"].to(device),
            attention_mask=enc["attention_mask"].to(device)).float().cpu()
    hf_scores = _mcm_host(img_f.numpy(), txt_f.numpy())

    prec = Precision.parity()
    ids, mask = tokenizer(prompts, pad_to_multiple=8,
                          context_length=cfg.text.context_length)
    with torch.inference_mode():
        x = normalize_on_device(torch.from_numpy(imgs).to(device),
                                dtype=torch.float32)
        our_img = tclip.encode_image(ours, cfg.vision, x, prec)
        our_txt = tclip.encode_text(
            ours, cfg.text, torch.from_numpy(ids.astype(np.int64)).to(device),
            torch.from_numpy(mask.astype(np.int64)).to(device), prec)
        our_scores = compute_scores(our_img, l2_normalize(our_txt),
                                    score="MCM").float().cpu().numpy()
    return hf_scores.astype(np.float32), our_scores.astype(np.float32)


def full_report(args) -> dict:
    """The one-command parity rehearsal on an HF snapshot: tokenizer ids,
    per-layer activations, score parity and (with trees) metric deltas
    through both pipelines, written to ``--out``."""
    if args.ood_tree and not args.id_tree:
        raise SystemExit("--ood-tree requires --id-tree (metrics compare an "
                         "ID/OOD pair); refusing to emit a PASS that skipped "
                         "the request")
    import transformers

    dev = _reference_device(args.device)
    cfg = CLIP_CONFIGS[args.ckpt]()
    hf_dir = args.hf_dir or os.path.join(
        args.ckpt_dir, HF_CKPT_MAPPING[args.ckpt].split("/")[-1])
    if not os.path.isdir(hf_dir):
        raise SystemExit(f"no HF snapshot at {hf_dir} (pass --hf-dir)")

    lines = [f"# Parity report — {args.ckpt}", "",
             f"HF snapshot: `{hf_dir}`  ·  transformers "
             f"{transformers.__version__}", ""]
    ok = True
    row: Dict[str, object] = {"ckpt": args.ckpt, "out": args.out}

    model = _hf_model(hf_dir, dev)
    params = resolve_clip_params(args.ckpt, args.ckpt_dir)
    if params is None:
        raise SystemExit(f"the port's converter found no weights under "
                         f"{args.ckpt_dir}")
    prec = Precision.parity()
    ours = from_jax_params(params, dev, prec.activation_dtype)
    del params
    tokenizer = CLIPTokenizer.resolve(args.ckpt_dir)

    tok_ok = _tokenizer_report(hf_dir, args.ckpt_dir, lines)
    row["tokenizer_ok"] = tok_ok
    ok &= tok_ok

    # per-layer activations on deterministic probe inputs
    pixels, ids, mask = probe_inputs(batch=4, n_prompts=8,
                                     vocab_size=cfg.text.vocab_size)
    img, txt, vhs, ths = _hf_features(model, pixels, ids, mask, dev,
                                      hidden=True)
    our_img, our_txt, vh, th = _encode(ours, cfg, pixels, ids, mask, prec,
                                       dev, collect_hidden=True)

    lines.append("## Per-layer activations (probe inputs, parity "
                 "precision)\n")
    lines.append("| layer | vision max-rel | text max-rel |")
    lines.append("|---|---|---|")
    layer_ok = True
    for i in range(max(len(vhs), len(ths))):
        v = max_rel(vh[i], vhs[i]) if i < len(vhs) else None
        t = max_rel(th[i], ths[i]) if i < len(ths) else None
        layer_ok &= all(x is None or x < LAYER_TOL for x in (v, t))
        lines.append(f"| {i} | {v if v is None else f'{v:.2e}'} "
                     f"| {t if t is None else f'{t:.2e}'} |")
    fi, ft = max_rel(our_img, img), max_rel(our_txt, txt)
    layer_ok &= fi < LAYER_TOL and ft < LAYER_TOL
    lines.append(f"\nfinal features: image {fi:.2e}, text {ft:.2e} — "
                 f"{'PASS' if layer_ok else 'FAIL'} (tol {LAYER_TOL:g})\n")
    row.update(image_features_max_rel=fi, text_features_max_rel=ft,
               layers_ok=bool(layer_ok))
    ok &= layer_ok

    # optional: per-image scores and metrics through both pipelines
    if args.id_tree:
        hf_id, our_id = _score_tree_both(args.id_tree, model, hf_dir, ours,
                                         cfg, tokenizer, args.max_images, dev)
        d_id = float(np.abs(hf_id - our_id).max())
        score_ok = d_id < SCORE_TOL
        lines.append(f"## Score parity — ID tree `{args.id_tree}`\n\n"
                     f"{len(hf_id)} images: max per-image MCM delta "
                     f"{d_id:.2e} — {'PASS' if score_ok else 'FAIL'} "
                     f"(tol {SCORE_TOL:g})\n")
        row["id_max_score_delta"] = d_id
        ok &= score_ok
        if args.ood_tree:
            hf_ood, our_ood = _score_tree_both(args.ood_tree, model, hf_dir,
                                               ours, cfg, tokenizer,
                                               args.max_images, dev)
            d_ood = float(np.abs(hf_ood - our_ood).max())
            m_hf = get_measures(-hf_id, -hf_ood)
            m_us = get_measures(-our_id, -our_ood)
            d_auroc = abs(m_hf[0] - m_us[0]) * 100
            metric_ok = d_ood < SCORE_TOL and d_auroc < AUROC_TOL_PP
            lines.append(
                f"## Metrics — OOD tree `{args.ood_tree}`\n\n"
                f"{len(hf_ood)} images: max OOD score delta {d_ood:.2e}; "
                f"AUROC {100 * m_hf[0]:.3f} (HF-side) vs "
                f"{100 * m_us[0]:.3f} (ours), |Δ| = {d_auroc:.4f} pp — "
                f"{'PASS' if metric_ok else 'FAIL'} (north star ≤0.1 pp)\n")
            row.update(ood_max_score_delta=d_ood, auroc_delta_pp=d_auroc)
            ok &= metric_ok

    lines.append(f"\n**OVERALL: {'PASS' if ok else 'FAIL'}**\n")
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {args.out}: {'PASS' if ok else 'FAIL'}")
    row["ok"] = bool(ok)
    return row


MODES = {"record": record, "check": check, "record-synth": record_synth,
         "full-report": full_report}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    device = dict(default="cuda", choices=("cuda", "cpu"),
                  help="cuda (default; raises without a card) or cpu")
    pr = sub.add_parser("record")
    pr.add_argument("--ckpt", default="ViT-B/16", choices=CKPTS)
    pr.add_argument("--hf-dir", required=True)
    pr.add_argument("--out", required=True)
    pr.add_argument("--device", **device)
    pc = sub.add_parser("check")
    pc.add_argument("--ckpt", default="ViT-B/16", choices=CKPTS)
    pc.add_argument("--goldens", required=True)
    pc.add_argument("--ckpt-dir", default=None)
    pc.add_argument("--precision", default="parity")
    pc.add_argument("--device", **device)
    ps = sub.add_parser("record-synth")
    ps.add_argument("--seed", default=0, type=int)
    ps.add_argument("--config", default="golden",
                    choices=["golden", "b16", "l14"])
    ps.add_argument("--layer-stride", default=1, type=int,
                    help="record every Nth hidden layer (embeddings and "
                         "final always included)")
    ps.add_argument("--out", required=True,
                    help="the .npz to write (required: the committed goldens "
                         "in tests/goldens/ are the JAX package's)")
    ps.add_argument("--device", **device)
    pf = sub.add_parser(
        "full-report",
        help="one-command real-weights parity rehearsal → PARITY_REPORT.md")
    pf.add_argument("--ckpt", default="ViT-B/16", choices=CKPTS)
    pf.add_argument("--ckpt-dir", default="checkpoints",
                    help="dir holding the HF snapshot "
                         "(<ckpt-dir>/clip-vit-*-patch*/) or converted npz "
                         "+ vocab files")
    pf.add_argument("--hf-dir", default=None,
                    help="explicit HF snapshot dir (default: derived from "
                         "--ckpt-dir)")
    pf.add_argument("--id-tree", default=None,
                    help="ImageFolder tree for per-image score parity")
    pf.add_argument("--ood-tree", default=None,
                    help="second tree: AUROC through both pipelines")
    pf.add_argument("--max-images", default=64, type=int)
    pf.add_argument("--out", default="PARITY_REPORT.md")
    pf.add_argument("--device", **device)
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    """Run one mode, print its JSON line and return it (``ok`` says whether
    its gate held)."""
    args = parser().parse_args(argv)
    row = {"tool": "parity_check", "mode": args.mode, "device": args.device,
           **MODES[args.mode](args)}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)

#!/usr/bin/env python3
"""Kernel times of two checkouts of the port, in turns, on one GPU.

    python3 chip_ab.py OLD_ROOT NEW_ROOT [GROUP ...]

Each root is a checkout holding ``src/repro_torch`` (for instance the parent
commit unpacked with ``git archive`` beside the change).  The script runs
one process per tree in the order old, new, new, old, so that both versions
are timed on the same card in the same call; each process builds its
tree's kernels and prints one JSON line of medians over CUDA events (20
launches after 3 warm-ups) at the shapes of ``chip_smoke.py``'s phase 1.
Groups (all by default):

  dsj     range_search (int64 and int32) and span_search (M = 1) at every
          row of phase 1, with ``torch.searchsorted`` x2 beside them, and
          expand at every row; the inputs are phase 1's, rebuilt from their
          seeds by this checkout's ``chip_smoke.py``
  bucket  bucket_by_dest at every row of phase 1 (the reply routing and
          hash exchange rows at LUBM-100's shapes and mixes, then the
          overflow and random rows), rebuilt from their seeds by this
          checkout's ``chip_smoke.py``; beside each row's time, one call's
          device time, in all and for its five longest kernels
          (torch.profiler)
  flash   the bf16 flash_attention rows below 32k, with
          ``F.scaled_dot_product_attention`` beside them
  flash_bwd  the bf16 rows of phase 1's attention backward
          (``chip_smoke.FLASH_BWD_SHAPES``, the train phase's shape first;
          the audio train step's and the hybrid's windowed hd-256 rows
          among them):
          ``flash_attention_bwd_cuda`` on the forward kernel's o and
          log-sum-exp, with SDPA's backward beside it; beside each row's
          time, one call's device time by kernel (torch.profiler: the
          passes of the backward)
  unique  the unique_compact rows, with ``torch.unique`` beside them
  lubm    LUBM-100 as phase 2 drives it (W = 8, 60 workload queries after
          a cold pass): each template's warm p50 (ms) and its device busy
          time in one profiled warm pass (s)
  lm      llama3-8b as phase 4 drives it (bf16 weights from seed 0):
          prefill on B=4, T=4096 under ``torch.inference_mode()``, one cold
          call and three warm (tokens/s of the warm mean), then decode
          (``serve_loop``: batch 8, max_len 128, 16 steps, 4 batches with
          the adaptive controller; tokens/s by ``launch/serve.py``'s
          formula, and each batch's seconds)
  lm-cache  llama3-8b decode in the three cache modes of ``chip_smoke.py``'s
          ``lm-int8`` phase (``CACHE_MODES``: float32 cache math, bf16
          cache math, the int8 cache with bf16 math) on one set of bf16
          weights from seed 0, ``serve_loop`` at batch 8, max_len 4096, 16
          steps, 4 batches, in turns (default, bf16, int8, int8, bf16,
          default): each mode's tokens/s twice.  The modes are compared
          inside one process; a tree before the options has none, so
          run it with the same root twice: ``chip_ab.py . . lm-cache``
  moe     qwen2-moe-a2.7b as the moe phase drives it, the same calls and
          tokens/s as ``lm`` (the controller's budget from its config)
  ssm, hybrid, vlm  mamba2-130m, recurrentgemma-2b and internvl2-2b as
          their phases drive them, the same calls and tokens/s as ``lm``
          (a vlm prefill is 256 patches and 3,840 tokens a row; its
          tokens/s count both)
  audio   whisper-tiny as the audio phase drives it (bf16 weights from
          seed 0): prefill (``model.loss`` on 16 rows of 1,500 frames and
          448 tokens, one cold call and three warm; tokens/s of the warm
          mean, frames and tokens both), ``whisper_encode`` of 8 rows (ms),
          and decode through ``make_serve_step`` over the encoder states
          (batch 8, max_len 128, 16 steps, 4 batches; tokens/s by
          ``launch/serve.py``'s formula)

The last line holds each key's times per tree.  Without a card it exits 1.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (name, B, T, H, KV, hd, causal): chip_smoke.py phase 1's bf16 rows
FLASH = [("main B=4", 4, 4096, 32, 8, 128, True),
         ("B=1", 1, 4096, 32, 8, 128, True),
         ("non-causal", 1, 4096, 32, 8, 128, False),
         ("T=S=1000", 1, 1000, 32, 8, 128, True),
         ("MHA H=KV=20", 1, 4096, 20, 20, 128, True),
         ("hd=64", 1, 4096, 32, 8, 64, True),
         ("hd=16", 1, 4096, 32, 8, 16, True)]
# (n, value range, out_cap, dtype) per worker row, W = 8
UNIQUE = [(1 << 10, 800, 256, "int32"), (1 << 18, 1 << 17, 1 << 16, "int32"),
          (1 << 18, 1 << 17, 1 << 16, "int64")]
GROUPS = ("dsj", "bucket", "flash", "flash_bwd", "unique", "lubm", "lm",
          "lm-cache", "moe", "ssm", "hybrid", "vlm", "audio")
#: the model groups past ``lm``: group -> arch (``chip_smoke.py``'s)
FAMILIES = {"moe": "MOE_ARCH", "ssm": "SSM_ARCH", "hybrid": "HYBRID_ARCH",
            "vlm": "VLM_ARCH"}


def measure(root: str, groups: list[str]) -> dict:
    """Times of one tree's kernels (runs in a process of its own)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke  # this checkout's: the inputs of phase 1

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.relalg_ops.bucket import bucket_by_dest_cuda
    from repro_torch.kernels.relalg_ops.compact import unique_compact_cuda
    from repro_torch.kernels.relalg_ops.expand import expand_cuda
    from repro_torch.kernels.semijoin.probe import (range_search_cuda,
                                                    span_search_cuda)

    def time_ms(fn) -> float:
        return chip_smoke.time_ms(torch, fn)

    dev = torch.device("cuda")
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out: dict = {}
    if "dsj" in groups:
        for variant, keys, probes, probes_hi, _ in \
                chip_smoke.range_search_cases():
            k_t, p_t = cuda(keys), cuda(probes)
            q_t = p_t if probes_hi is None else cuda(probes_hi)
            if probes_hi is None:
                out[f"range_search {variant}"] = time_ms(
                    lambda: range_search_cuda(k_t, p_t))
            else:
                out[f"range_search {variant}"] = time_ms(
                    lambda: span_search_cuda(k_t, p_t, q_t))
            side = "right" if probes_hi is None else "left"
            out[f"torch.searchsorted x2 {variant}"] = time_ms(lambda: (
                torch.searchsorted(k_t, p_t, side="left", out_int32=True),
                torch.searchsorted(k_t, q_t, side=side, out_int32=True)))
            del k_t, p_t, q_t
        for variant, lo, hi, cap, _ in chip_smoke.expand_cases():
            lo_t, hi_t = cuda(lo), cuda(hi)
            out[f"expand {variant}"] = time_ms(
                lambda: expand_cuda(lo_t, hi_t, cap))
            del lo_t, hi_t
        torch.cuda.empty_cache()
    if "bucket" in groups:
        for variant, vals, dest, valid, nd, cap, _ in \
                chip_smoke.bucket_cases():
            v_t, d_t, m_t = cuda(vals), cuda(dest), cuda(valid)
            fn = lambda: bucket_by_dest_cuda(v_t, d_t, m_t, nd, cap)
            out[f"bucket_by_dest {variant}"] = time_ms(fn)
            prof = chip_smoke.profile_run(torch, fn)
            out[f"bucket_by_dest device ms {variant}"] = {
                "all": prof["device_busy_s"] * 1e3,
                **{t["kernel"]: t["ms"] for t in prof["top"]}}
            del v_t, d_t, m_t
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for name, b, t, h, kv, hd, causal in FLASH if "flash" in groups \
                else ():
            q, k, v = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16)
                       for shape in ((b, t, h, hd), (b, t, kv, hd),
                                     (b, t, kv, hd)))
            out[f"flash_attention {name}"] = time_ms(
                lambda: flash_attention_cuda(q, k, v, causal=causal))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            out[f"sdpa {name}"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
    if "flash_bwd" in groups:
        out.update(measure_flash_bwd(torch, chip_smoke))
    rng = np.random.default_rng(0)
    for n, hi, cap, dt in UNIQUE if "unique" in groups else ():
        vals = torch.from_numpy(rng.integers(0, hi, (8, n)).astype(dt)).to(dev)
        valid = torch.from_numpy(rng.random((8, n)) < 0.9).to(dev)
        pad = int(np.iinfo(dt).max)
        tag = f"{dt} n=2^{n.bit_length() - 1}"
        out[f"unique_compact {tag}"] = time_ms(
            lambda: unique_compact_cuda(vals, valid, cap, pad))
        offs = torch.arange(8, device=dev, dtype=torch.int64)[:, None] << 32
        keyed = torch.where(valid, vals, pad).to(torch.int64) + offs
        out[f"torch.unique {tag}"] = time_ms(
            lambda: torch.unique(keyed.view(-1), sorted=True))
    if "lubm" in groups:
        out.update(measure_lubm(torch, chip_smoke))
    if "lm" in groups:
        out.update(measure_lm(torch, chip_smoke, "llama3-8b"))
    if "lm-cache" in groups:
        out.update(measure_lm_cache(torch, chip_smoke))
    for group, attr in FAMILIES.items():
        if group in groups:
            out.update({f"{group} {key}": v for key, v in measure_lm(
                torch, chip_smoke, getattr(chip_smoke, attr)).items()})
    if "audio" in groups:
        out.update(measure_audio(torch, chip_smoke))
    return out


def measure_flash_bwd(torch, chip_smoke) -> dict[str, float]:
    """Medians of the bf16 attention backward and of SDPA's backward at
    phase 1's bf16 backward rows; a tree whose backward takes no window
    (it names its head dims ``BWD_HEAD_DIMS``) leaves out the rows with a
    window or another head dim."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_cuda, flash_attention_cuda)

    old_dims = getattr(ops, "BWD_HEAD_DIMS", None)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name, b, t, s, h, kv, hd, dt, causal, off, *rest in \
            chip_smoke.FLASH_BWD_SHAPES:
        if dt != "bfloat16":
            continue
        w = rest[0] if rest else 0
        if old_dims is not None and (w > 0 or hd not in old_dims):
            continue
        mk = dict(causal=causal, q_offset=off, window=w)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev
                                         ).to(torch.bfloat16)
        q, k, v, do = rnd(b, t, h, hd), rnd(b, s, kv, hd), \
            rnd(b, s, kv, hd), rnd(b, t, h, hd)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **mk)
        fn = lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse, **mk)
        out[f"flash_attention_bwd {name}"] = chip_smoke.time_ms(torch, fn)
        prof = chip_smoke.profile_run(torch, fn)
        out[f"flash_attention_bwd device ms {name}"] = {
            t["kernel"]: t["ms"] for t in prof["top"]}
        mask = None
        if (causal and off) or w > 0:
            kpos = torch.arange(s, device=dev)[None, :]
            qpos = off + torch.arange(t, device=dev)[:, None]
            mask = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
            if w > 0:
                mask = mask & (kpos > qpos - w)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        res = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        dot = do.transpose(1, 2)
        out[f"sdpa backward {name}"] = chip_smoke.time_ms(
            torch, lambda: res.backward(dot, retain_graph=True))
        del q, k, v, do, o, lse, qt, kt, vt, res, dot, mask, fn
        torch.cuda.empty_cache()
    return out


def measure_lubm(torch, chip_smoke) -> dict[str, float]:
    """Warm p50 and profiled device busy time of each LUBM-100 template."""
    import time

    import numpy as np
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import Workload, lubm_like

    d, triples = lubm_like(100, 20, 30, 12, 2)
    eng = AdHashEngine(triples, chip_smoke.W, adaptive=False, device="cuda")
    queries = Workload(d, seed=0).sample(60)
    for q in queries:  # the cold pass
        eng.query(q)
    torch.cuda.synchronize()
    lat: dict[str, list[float]] = {}
    for q in queries:
        a = time.perf_counter()
        eng.query(q)
        torch.cuda.synchronize()
        lat.setdefault(q.name, []).append(time.perf_counter() - a)
    out = {f"lubm p50 ms {k}": float(np.percentile(v, 50)) * 1e3
           for k, v in sorted(lat.items())}
    for name in sorted(lat):
        picked = [q for q in queries if q.name == name]
        prof = chip_smoke.profile_run(
            torch, lambda: [eng.query(q) for q in picked])
        out[f"lubm device busy s {name}"] = prof["device_busy_s"]
    return out


def measure_lm(torch, chip_smoke, arch: str) -> dict:
    """Warm prefill and steady decode tokens/s of ``arch``."""
    import time

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import AdaptiveShardingController
    from repro_torch.data.tokens import make_batch
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.model_zoo import build_model

    cfg = get_config(arch)
    model = build_model(cfg, device="cuda")
    params = model.init(0, dtype=torch.bfloat16)
    b, t = chip_smoke.PREFILL  # a vlm row: its patches, then the text
    prefix = cfg.vlm.n_patches if cfg.vlm is not None else 0
    batch = make_batch(cfg, b, t - prefix, 0, device="cuda")
    prefill_s = []
    for _ in range(4):  # one cold call, three warm
        a = time.perf_counter()
        with torch.inference_mode():
            float(model.loss(params, batch))
        prefill_s.append(time.perf_counter() - a)
    budget = cfg.adaptive.embedding_hot_budget if cfg.adaptive else 8192
    ctrl = AdaptiveShardingController(cfg.vocab_size, budget=budget)
    times, _ = serve_loop(model, params, batch_size=8, max_len=128,
                          steps=16, n_batches=4, controller=ctrl)
    return {"prefill tokens/s": b * t / float(np.mean(prefill_s[1:])),
            "decode tokens/s": 8 * 16 / float(np.mean(times[1:])),
            "decode batch s": [float(x) for x in times]}


def measure_lm_cache(torch, chip_smoke) -> dict:
    """llama3-8b's steady decode tokens/s in each cache mode, in turns."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import RuntimeOptions

    cfg = get_config("llama3-8b")
    models = {mode: build_model(cfg, opts=RuntimeOptions(**kw),
                                device="cuda")
              for mode, kw in chip_smoke.CACHE_MODES.items()}
    params = models["default"].init(0, dtype=torch.bfloat16)
    b, max_len, steps, n = chip_smoke.CACHE_DECODE
    order = list(models) + list(reversed(models))
    out: dict = {f"lm-cache {mode} decode tokens/s": [] for mode in models}
    for mode in order:
        times, _ = serve_loop(models[mode], params, batch_size=b,
                              max_len=max_len, steps=steps, n_batches=n)
        out[f"lm-cache {mode} decode tokens/s"].append(
            b * steps / float(np.mean(times[1:])))
    return out


def measure_audio(torch, chip_smoke) -> dict:
    """whisper-tiny's warm prefill tokens/s, encoder ms and steady decode
    tokens/s, as the audio phase drives them."""
    import time

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch, zipf_tokens
    from repro_torch.launch.train import make_serve_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.whisper import whisper_encode

    cfg = get_config(chip_smoke.AUDIO_ARCH)
    model = build_model(cfg, device="cuda")
    params = model.init(0, dtype=torch.bfloat16)
    b, t = chip_smoke.AUDIO
    batch = make_batch(cfg, b, t, 0, device="cuda")
    prefill_s = []
    for _ in range(4):  # one cold call, three warm
        a = time.perf_counter()
        with torch.inference_mode():
            float(model.loss(params, batch))
        prefill_s.append(time.perf_counter() - a)
    with torch.inference_mode():
        rows8 = batch["frames"][:8]
        encode_ms = chip_smoke.time_ms(
            torch, lambda: whisper_encode(params, rows8, cfg))
        enc = whisper_encode(params, rows8, cfg)
    serve = make_serve_step(model)
    rng = np.random.default_rng(0)
    times = []
    for _ in range(4):
        cache = model.init_cache(8, 128)
        tok = torch.from_numpy(zipf_tokens(rng, cfg.vocab_size, (8, 1))
                               .astype(np.int64)).cuda()
        a = time.perf_counter()
        for pos in range(16):
            nxt, cache = serve(params, cache, {"enc": enc, "tokens": tok,
                                               "pos": pos})
            tok = nxt[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - a)
    positions = b * (cfg.encdec.n_frames + t)
    return {"audio prefill tokens/s": positions / float(np.mean(
                prefill_s[1:])),
            "audio encode 8 rows ms": encode_ms,
            "audio decode tokens/s": 8 * 16 / float(np.mean(times[1:])),
            "audio decode batch s": [float(x) for x in times]}


def main(argv: list[str]) -> int:
    import torch

    if len(argv) >= 3 and argv[1] == "--measure":
        print(json.dumps(measure(argv[2], argv[3:])), flush=True)
        return 0
    groups = argv[3:] or list(GROUPS)
    if len(argv) < 3 or any(g not in GROUPS for g in groups):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    old, new = argv[1:3]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs: dict[str, list[dict]] = {"old": [], "new": []}
    for tag, root in (("old", old), ("new", new), ("new", new), ("old", old)):
        res = subprocess.run(
            [sys.executable, __file__, "--measure", root, *groups],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tag, "root": root, **row}), flush=True)
        runs[tag].append(row)
    print(json.dumps({key: {tag: [r.get(key) for r in rows]
                            for tag, rows in runs.items()}
                      for key in runs["new"][0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

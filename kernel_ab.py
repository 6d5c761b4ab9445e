#!/usr/bin/env python3
"""Compare the CUDA kernels of two checkouts of this repo on one card.

    python3 kernel_ab.py --tree parent=DIR \\
        --tree change=. --order parent,change,change,parent --out OUT

It sits beside ``chip_smoke.py``, whose stages it drives.  Each run of
the order is a process of its own that imports the named tree's
``deepspeed_tpu_torch`` and ``chip_smoke.py``, builds that tree's
kernels (into the tree's own build directory, all sources at once), then:

- hashes (sha256 of the bytes) the outputs of the flash-attention kernels
  (B1: forward, dq, dk/dv) at chip_smoke stage 7's training shape
  ([4, 2048, 32, 128] bf16, causal) and stage 10's GPT-2 shape ([8, 1024,
  16, 64] fp16), and of the bias flash kernels (B10: forward, dq, dk/dv,
  dbias) at stage 17's MSA-row shape ([512, 384, 8, 32] bf16, pair bias
  over 512 rows, key mask), inputs from a fixed seed;
- runs chip_smoke's stages 3 (paged attention), 7, 13, 17 and 19, and
  the kernel cases of 21 (FP6/FP12, B6) and 31 (a) (B7's dx and dw at
  Mixtral's training shapes) (``--stages``), and keeps the times of each
  kernel case (its ``ms``, and its ``library_ms`` where it has one);
- with ``trees`` among the stages, times through the public functions of
  either tree: the quantize of ``p.t()`` of Llama-2-7B's gate projection
  (the int8 serving build's call), ``quantize_fp`` at stage 21's shapes,
  ``quant_serving.quantize_tree`` over Llama-2-7B's 226 weights in int8
  (loaded as the int8 serving build loads them)
  and ``quantize_param_tree`` over its bf16 tree in FP6 and FP12 (wall
  time, and the device time of their kernels under ``torch.profiler``).

It also reads the SASS of B7's forward ``wgmma``/TMA kernels out of each
tree's built library (``cuobjdump -sass`` and ``-res-usage``, beside
nvcc): per instantiation its registers, its instruction count and a
hash of its instructions with addresses and the symbol's own name taken
out, so two trees' builds of one kernel compare instruction for
instruction.

It writes one JSON file a run and prints, per kernel case, each run's ms
and whether every run's output hashes agree.  Runs alternate (parent,
change, change, parent) so that a drift of the card's clock shows as a
difference between the two runs of one tree.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

STAGES = {"3": "stage_kernels", "7": "stage_train_kernels",
          "13": "stage_moe_quant_kernels",
          "17": "stage_evoformer_kernels", "19": "stage_sparse_kernels",
          "21": "stage_fp_quant_kernels", "31": "stage_moe_train_kernels"}


def _digest(t):
    return hashlib.sha256(t.contiguous().cpu().view(-1).view(
        __import__("torch").uint8).numpy().tobytes()).hexdigest()[:16]


def _hashes(torch):
    """sha256 prefixes of B1's and B10's outputs on seeded inputs."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import flash_bias as fb
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for name, (B, S, H, D, dtype) in {
            "b1_train_bf16": (4, 2048, 32, 128, torch.bfloat16),
            "b1_gpt2_fp16": (8, 1024, 16, 64, torch.float16)}.items():
        q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=gen)
                       .to(dtype) for _ in range(4))
        scale = D ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale, causal=True)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, scale,
                                              causal=True)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                            causal=True)
        for key, t in dict(o=o, lse=lse, dq=dq, delta=delta, dk=dk,
                           dv=dv).items():
            out[f"{name}.{key}"] = _digest(t)
    BN, L, H, D = 512, 384, 8, 32
    q, k, v, do = (torch.randn(BN, L, H, D, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    bias = torch.randn(1, H, L, L, device="cuda",
                       generator=gen).to(torch.bfloat16)
    mask = torch.where(torch.rand(BN, 1, 1, L, device="cuda",
                                  generator=gen) < 0.1, -1e9, 0.0)
    scale = D ** -0.5
    o, lse = fb.flash_bias_fwd(q, k, v, bias, mask, scale)
    dq, delta = fb.flash_bias_bwd_dq(q, k, v, o, do, lse, bias, mask, scale)
    dk, dv = fb.flash_bias_bwd_dkv(q, k, v, do, lse, delta, bias, mask,
                                   scale)
    dbias = fb.flash_bias_bwd_dbias(q, k, v, do, lse, delta, bias, mask,
                                    scale)
    for key, t in dict(o=o, lse=lse, dq=dq, delta=delta, dk=dk, dv=dv,
                       dbias=dbias).items():
        out[f"b10_msa_row_bf16.{key}"] = _digest(t)
    return out


_GMM_FWD = re.compile(r"gmm_tma_kernelI(13__nv_bfloat16|6__half)Li(\d)E"
                      r"(?:Lb0E)?E")


def _gmm_forward_sass():
    """{"<dtype>/nc<NC>": {registers, instructions, sha}} of B7's forward
    wgmma/TMA kernels in this tree's built library."""
    from deepspeed_tpu_torch.ops.op_builder import (GroupedMatmulBuilder,
                                                    find_nvcc)
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    lib = GroupedMatmulBuilder().lib_path()

    def key_of(line):
        m = re.search(r"Function\s*:?\s*(\S+)", line)
        if not m:
            return False
        m = _GMM_FWD.search(m.group(1))
        return m and (("bf16" if "bfloat16" in m.group(1) else "fp16") +
                      f"/nc{m.group(2)}")

    out, key = {}, None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    for line in sass.splitlines():
        k = key_of(line)
        if k is not False:
            key = k or None
            if key:
                out[key] = dict(instructions=0, text=[])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if key and m:
            out[key]["instructions"] += 1
            out[key]["text"].append(re.sub(r"0x[0-9a-f]+", "#", m.group(1)))
    for v in out.values():
        v["sha"] = hashlib.sha256("\n".join(v.pop("text")).encode()) \
            .hexdigest()[:16]
    usage = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                           text=True, timeout=300).stdout
    key = None
    for line in usage.splitlines():
        k = key_of(line)
        if k is not False:
            key = k or None
            continue
        m = re.search(r"REG:(\d+)", line)
        if key in out and m:
            out[key]["registers"] = int(m.group(1))
            key = None
    return out


def _times(result):
    """{case: ms} of the kernel cases a stage returned."""
    rows = []
    for v in (result if isinstance(result, list) else result.values()):
        rows += v if isinstance(v, list) else [v]
    times = {}
    for r in rows:
        if not isinstance(r, dict) or "case" not in r:
            continue
        for k, v in r.items():
            if (k in ("ms", "library_ms") or k.startswith("ms_")) and \
                    isinstance(v, float):
                times[f"{r['case']}.{k}"] = v
    return times


def _fp_kernel_cases(c, torch):
    """Stage 21's kernel cases; a tree whose chip_smoke predates
    ``stage_fp_quant_kernels`` (B6 writing unpacked codes) runs its
    ``_fpq_case`` over the same shapes.  That branch can go once no
    parent compared predates the stage."""
    if hasattr(c, "stage_fp_quant_kernels"):
        return c.stage_fp_quant_kernels(0)
    gen = torch.Generator(device="cuda").manual_seed(21)
    return [c._fpq_case(torch, gen, sn, shape, fmt, dtype)
            for sn, shape in c.FPQ_SHAPES for fmt in c.FPQ_FORMATS
            for dtype in ("bfloat16", "float32")]


def _llama_model(torch, gen, here):
    """Llama-2-7B as the int8 serving build holds it before
    ``quantize_tree``: stage 15's random checkpoint (``here``, this
    checkout's chip_smoke) loaded by the tree's own
    ``build_model_and_params`` (what
    ``build_engine_from_checkpoint`` runs), without the engine."""
    from deepspeed_tpu_torch.inference.v2.engine_factory import (
        _ConfiguredCheckpoint)
    from deepspeed_tpu_torch.inference.v2.model_implementations.hf_builders \
        import build_model_and_params
    ckpt = _ConfiguredCheckpoint(
        here._RandomCheckpoint(torch, here.LLAMA2_7B_HF, gen),
        here.LLAMA2_7B_HF)
    model, _ = build_model_and_params(
        ckpt, dtype=here.SERVE_ENGINE["dtype"],
        device=torch.device("cuda", torch.cuda.current_device()))
    return model


def _here_chip_smoke():
    """The chip_smoke.py beside this script (its helpers, whichever tree
    a run imports)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trees(c, torch):
    """The public functions' times (parent and change alike)."""
    import time
    from deepspeed_tpu_torch.inference import quant_serving
    from deepspeed_tpu_torch.linear import (QuantizationConfig,
                                            quantize_param_tree)
    from deepspeed_tpu_torch.ops import fp_quantizer as fq
    from deepspeed_tpu_torch.ops.kernels import quantizer as qz
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    p = (torch.randn(11008, 4096, device="cuda", generator=gen)
         * 0.02).to(torch.bfloat16)
    rows.append(dict(case="gate_proj_t_int8_g128", ms=c.cuda_ms(
        lambda: qz.quantize_blockwise(p.t(), 8, 128), 10)))
    del p
    for sn, shape in c.FPQ_SHAPES:
        x = (torch.randn(*shape, device="cuda", generator=gen)
             * 0.02).to(torch.bfloat16)
        for fmt, (q_bits, man) in c.FPQ_FORMATS.items():
            rows.append(dict(case=f"quantize_fp_{sn}_{fmt}", ms=c.cuda_ms(
                lambda: fq.quantize_fp(x, q_bits, man, 512), 10)))
        del x
    c._free(torch)
    # quantize_tree and quantize_param_tree: wall (synchronized) in a
    # plain run, the device time of their kernels in a run under the
    # profiler (chip_smoke.device_time of this checkout), which slows the
    # host
    here = _here_chip_smoke()

    def timed(tag, body, profiled):
        if profiled:
            out, wall, dev, records = here.device_time(torch, body)
            rows.append(dict(case=tag, ms_device=dev, ms_wall_profiled=wall,
                             records=float(records)))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = body()
            torch.cuda.synchronize()
            rows.append(dict(case=tag,
                             ms_wall=(time.perf_counter() - t0) * 1e3))
        return out

    for rep, profiled in enumerate((False, True)):
        model = _llama_model(torch, gen, here)
        timed(f"quantize_tree_llama2_7b_int8_{rep}",
              lambda: quant_serving.quantize_tree(model, 8, torch.bfloat16),
              profiled)
        del model
        c._free(torch)
    tree = c._llama_jax_tree(torch, gen)
    for fmt, q_bits in (("fp6", 6), ("fp12", 12)):
        for rep, profiled in enumerate((False, False, True)):
            qt = timed(f"quantize_param_tree_{fmt}_{rep}",
                       lambda: quantize_param_tree(tree, QuantizationConfig(
                           q_dtype="fp", q_bits=q_bits)), profiled)
            del qt
        c._free(torch)
    del tree
    c._free(torch)
    return rows


def run_one(tree, stages, out_path):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import chip_smoke as c
    from deepspeed_tpu_torch.ops.op_builder import build_all
    build_all()
    res = dict(tree=os.path.abspath(tree), card=c.stage_environment(),
               hashes=_hashes(torch), times={},
               gmm_forward_sass=_gmm_forward_sass())
    for st in stages:
        if st == "trees":
            result = _trees(c, torch)
        elif st == "21":
            result = _fp_kernel_cases(c, torch)
        else:
            result = getattr(c, STAGES[st])(0)
        res["times"].update({f"{st}:{k}": v
                             for k, v in _times(result).items()})
        c._free(torch)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, once per tree")
    ap.add_argument("--order", required=True,
                    help="comma-separated tree names, run in this order")
    ap.add_argument("--stages", default="3,7,13,17,19,21")
    ap.add_argument("--out", required=True, help="directory for the JSON")
    ap.add_argument("--one", nargs=2, metavar=("TREE", "OUT"),
                    help=argparse.SUPPRESS)   # a child process's run
    args = ap.parse_args()
    stages = [s for s in args.stages.split(",") if s]
    if args.one:
        run_one(args.one[0], stages, args.one[1])
        return 0
    trees = {name: os.path.abspath(d)
             for name, d in (t.split("=", 1) for t in args.tree)}
    out = os.path.abspath(args.out)     # the runs' cwd is their tree
    os.makedirs(out, exist_ok=True)
    runs = []
    for i, name in enumerate(args.order.split(",")):
        path = os.path.join(out, f"{i}_{name}.json")
        log = os.path.join(out, f"{i}_{name}.log")
        with open(log, "w") as f:
            rc = subprocess.call(
                [sys.executable, os.path.abspath(__file__), "--tree",
                 f"{name}={trees[name]}", "--order", name, "--stages",
                 args.stages, "--out", out, "--one", trees[name],
                 path], stdout=f, stderr=subprocess.STDOUT,
                cwd=trees[name])
        if rc:
            print(f"run {i} ({name}) failed with rc {rc}; see {log}")
            return rc
        with open(path) as f:
            runs.append((name, json.load(f)))
    print(f"card: {runs[0][1]['card']}")
    names = [f"{i}_{n}" for i, (n, _) in enumerate(runs)]
    print("case | " + " | ".join(names))
    for key in sorted(set().union(*(r["times"] for _, r in runs))):
        print(f"{key} | " + " | ".join(
            f"{r['times'][key]:.4f}" if key in r["times"] else "-"
            for _, r in runs))
    for key in sorted(runs[0][1]["gmm_forward_sass"]):
        print(f"B7 forward {key} SASS (registers, instructions, sha) | "
              + " | ".join(
                  "{registers}, {instructions}, {sha}".format(
                      **r["gmm_forward_sass"].get(key, dict(
                          registers="-", instructions="-", sha="-")))
                  for _, r in runs))
    bad = [k for k in runs[0][1]["hashes"]
           if len({r["hashes"].get(k) for _, r in runs}) != 1]
    print(f"output hashes ({len(runs[0][1]['hashes'])} tensors of B1 and "
          f"B10): {'all equal' if not bad else f'DIFFER: {bad}'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

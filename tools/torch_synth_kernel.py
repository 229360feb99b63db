"""The port's synthesis kernel alone on one CUDA card: build, check, time,
disassemble. Under a minute, where chip_smoke.py takes minutes; it owns the
per-variant times, chip_smoke.py the checks and the streams' batches.

    python3 tools/torch_synth_kernel.py [--sass-out build/synth_kernel.sass]

Prints JSON lines:
  build     nvcc's seconds and ptxas's registers / shared memory / spills of
            the synthesis kernel;
  check     kernel == plain version on short blocks for every compiled tap
            count, narrow and wide, and a block that goes wide midway;
  variants  CUDA-event ms of each tap count at M = 1024 subframes of B =
            4096 positions, int32 arithmetic ("narrow") and 64-bit ("wide"):
            "ms" through synthesize_batch as the decoder calls it,
            "kernel_ms" the kernel's launches alone, back to back (the
            wrapper's argument checks wait for the device once a call, which
            costs more than a fast variant runs), and the cycles per step
            that the latter amounts to at the boost clock; and two batches
            of fixed predictors (shift 0) with orders 0-2 and 0-4 mixed;
  subframes the same arithmetic at M = 1024, 4224 and 16896;
  sass      from cuobjdump's disassembly of the library that was timed: for
            each branch-free block of the kernel that holds one whole tile
            (32 shared-memory stores, one a step), its instructions per step
            by opcode. A narrow tile of T taps shows T signed IMAD.WIDE a
            step, a wide one IMAD.WIDE.U32 and two IMAD beside each.

It imports nothing of JAX. Numbers hold for the card it ran on: the line
"card" gives its name and power limit, "variants" its SM clock after the
timed launches. Two runs may land on two cards whose times differ by a
third: compare variants within one run.
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BOOST_HZ = 1.98e9  # H100 SXM boost clock
M, B = 1024, 4096
TAP_COUNTS = (0, 1, 2, 3, 4, 8, 16, 24, 32)


def log(what, **kv):
    print(json.dumps({"what": what, **kv}), flush=True)


def sass_tiles(text):
    """Per whole-tile block of the synthesis kernel's SASS: instructions per
    step by opcode."""
    tiles, block = [], []

    def close():
        ops = collections.Counter(block)
        if ops.get("STS.64", 0) == 32:
            per_step = {k: round(v / 32, 2) for k, v in sorted(ops.items())}
            tiles.append({"instructions_per_step": round(len(block) / 32, 2), "ops": per_step})
        block.clear()

    inside = False
    for line in text.splitlines():
        if "Function :" in line:
            close()
            inside = "synth_kernel" in line
            continue
        if not inside:
            continue
        if re.match(r"\s*\.L_", line):
            close()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not m:
            continue
        op = m.group(1)
        block.append(op)
        if op.split(".")[0] in ("BRA", "BRX", "EXIT", "RET", "BSYNC", "BAR", "WARPSYNC"):
            close()
    close()
    return tiles


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass-out", default=None, help="write the kernel library's SASS here")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_synth_kernel: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from chip_smoke import _fixed_subframes as fixed, _quiet_subframes as quiet, cuda_ms
    from zigflac_tpu_torch.ops import _build, synth

    def smi(fields):
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()

    log("card", smi=smi("name,power.limit"))
    lib = _build.library()
    lines = _build.BUILD_LOG.splitlines()
    at = [i for i, ln in enumerate(lines) if "synth_kernel" in ln]
    log("build", nvcc_s=_build.BUILD_SECONDS,
        ptxas=[ln.strip() for i in at for ln in lines[i:i + 3] if "Used" in ln or "spill" in ln])

    dev = torch.device("cuda")
    rng = np.random.default_rng(0x5A55)

    def on_card(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def run(args):
        synth.STATS = {}
        got = synth.synthesize_batch(*args)
        stats, synth.STATS = synth.STATS, None
        return got, synth.variant_counts(stats["variants"])

    def wide(a):
        a[0][::32, 0] = 1 << 40  # past int32 at the head of every block
        return a

    checked = []
    for taps in TAP_COUNTS:
        for form, a in (("narrow", quiet(rng, 70, 200, taps)),
                        ("wide", wide(quiet(rng, 70, 200, taps)))):
            args = on_card(a)
            got, v = run(args)
            if not torch.equal(got, synth.synthesize_batch_plain(*args)):
                raise AssertionError(f"kernel != plain at {taps} taps, {form}")
            if v["taps"] != {taps: 3} or v["narrow"] != (3 if form == "narrow" else 0):
                raise AssertionError(f"{taps} taps, {form}: ran as {v}")
            checked.append(f"{form}{taps}")
    a = quiet(rng, 64, 300, 8)
    a[0][9, 170] = 1 << 33
    args = on_card(a)
    got, v = run(args)
    if not torch.equal(got, synth.synthesize_batch_plain(*args)) or v["went_wide"] != 1:
        raise AssertionError(f"a block going wide midway: {v}")
    log("check", equal=checked + ["midway"])

    def timed(args, reps=20):
        """ms of the wrapper, and of the kernel's launches alone, back to back."""
        out = torch.empty_like(args[0])
        m, b = args[0].shape
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in args]
        raw = cuda_ms(torch, lambda: lib.zf_synthesize(*ptrs, m, b, out.data_ptr(), None, stream),
                      reps)
        ms = cuda_ms(torch, lambda: synth.synthesize_batch(*args), reps)
        return ms, raw, raw * 1e-3 * BOOST_HZ / b

    out = {}
    for taps in TAP_COUNTS:
        for form in ("narrow", "wide"):
            a = quiet(rng, M, B, taps)
            ms, raw, cyc = timed(on_card(wide(a) if form == "wide" else a))
            out[f"{form}{taps}"] = {"ms": ms, "kernel_ms": raw, "cycles_per_step": cyc}
    for max_order in (2, 4):
        args = on_card(fixed(rng, M, B, max_order))
        got, v = run(args)
        if not torch.equal(got, synth.synthesize_batch_plain(*args)) or v["narrow"] != M // 32:
            raise AssertionError(f"the fixed-predictor batch, orders 0-{max_order}: {v}")
        ms, raw, cyc = timed(args)
        out[f"fixed_orders_0_{max_order}"] = {"ms": ms, "kernel_ms": raw, "cycles_per_step": cyc,
                                              "blocks": v}
    # the SM clock right after the timed launches: two cards differ by more
    # than two variants do, so compare variants within one run only
    log("variants", m=M, b=B, boost_hz=BOOST_HZ, clocks=smi("clocks.sm,clocks.max.sm"), **out)

    log("subframes", kernel_ms={m: timed(on_card(quiet(rng, m, B, 4)), reps=5)[1]
                                for m in (1024, 132 * 32, 528 * 32)})

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True, text=True,
                          check=True).stdout
    if opts.sass_out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.sass_out)), exist_ok=True)
        with open(opts.sass_out, "w") as f:
            f.write(sass)
    log("sass", whole_tile_blocks=sass_tiles(sass))
    return 0


if __name__ == "__main__":
    sys.exit(main())

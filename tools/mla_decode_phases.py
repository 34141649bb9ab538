#!/usr/bin/env python3
"""Where the tensor-core MLA decode (``mla::decode_tc``) spends its
cycles, phase by phase, on one card.

    python3 tools/mla_decode_phases.py [mla_decode_bench.py arguments]

Copies ``src/repro_torch`` into ``build/mla_phases/src`` and inserts
``clock64()`` stamps into the copy's ``decode_tc``: thread 0 of each
warpgroup of the block of head block 0, split 0 and request 0 sums the
SM cycles of each phase (q staging; per key tile: the wait for its copy,
the S product, the S exchange, the softmax, the P V product, the end
barrier, the next tile's copy issue; the output store) and prints them
(device printf) at the end of each call, and the last block of request
1, head block 0, prints the cycles of its split merge. Then runs
``tools/mla_decode_bench.py`` on the copy with the given arguments
(default ``--case 1 256 1``: one request of 256 keys in one split, so
that the stamped block sweeps 8 tiles; the bench's own shape puts
request 1 at 4096 keys in 16 splits) and prints the median of each
phase over the calls. The stamps cost cycles of their own: read the
shares, not the sum, against the bench's times. Needs a CUDA card; the
stamps are inserted at lines of the source, so the tool fails with the
line it did not find if ``decode_tc`` changed.
"""
from __future__ import annotations

import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "mla_phases"
PHASES = ("q", "wait", "S", "xchg", "soft", "pv", "sync", "store",
          "ldissue")

# (anchor, text, before): ``text`` goes in before or after ``anchor``
STAMPS = (
    ("  const int h0 = hb * HB, ng = min(HB, H - h0);\n",
     "  long long t0_ = clock64(), tp_ = t0_, ph_[9] = {};\n"
     "  auto tick = [&](int k) { const long long t = clock64();\n"
     "                           ph_[k] += t - tp_; tp_ = t; };\n", False),
    ("  float o[NC / 2], ox[EX ? 32 : 1];\n", "  tick(0);\n", True),
    ("    hop::fence_async_smem();\n    __syncthreads();\n"
     "    const uint32_t kt = sk0 + (it & 1) * K_BYTES;\n",
     "    tick(1);\n", False),
    ("#pragma unroll\n    for (int i = 0; i < 16; ++i) sc[i] += sl[i];\n",
     "    tick(2);\n", False),
    ("    sum_halves(sc, sx + tid % hop::WG, g);\n", "    tick(3);\n", False),
    ("    // O += P V over this warpgroup's columns, P as hi + lo fragments\n",
     "    tick(4);\n", True),
    ("    __syncthreads();  // this stage is free for the copy after next\n"
     "  }\n", "    tick(5);\n", True),
    ("    __syncthreads();  // this stage is free for the copy after next\n"
     "  }\n", "  tick(6);\n", False),
    ("  for (int it = 0; it < n; ++it) {\n", "    tick(6);\n", False),
    ("      load_k(it + 1, row_next);\n      hop::cp_commit();\n",
     "      tick(8);\n", False),
    ("  if (whole) {\n    // each row's (m, l) is whole in every thread",
     "  tick(7);\n"
     "  if (hb == 0 && s == 0 && b == 0 && tid % hop::WG == 0)\n"
     "    printf(\"decode_tc phases g %d n %d: q %lld wait %lld S %lld \"\n"
     "           \"xchg %lld soft %lld pv %lld sync %lld store %lld \"\n"
     "           \"ldissue %lld total %lld\\n\", g, n, ph_[0], ph_[1],\n"
     "           ph_[2], ph_[3], ph_[4], ph_[5], ph_[6], ph_[7], ph_[8],\n"
     "           clock64() - t0_);\n", True),
    ("  if (!last) return;\n  __threadfence();\n  // the merge:",
     "  const long long tm_ = clock64();\n", True),
    ("  if (tid == 0) count[cnt] = 0;\n}\n\n// The shared-memory limit",
     "  if (tid == 0 && hb == 0 && b == 1)\n"
     "    printf(\"decode_tc merge ns %d: %lld\\n\", ns, clock64() - tm_);\n",
     True),
)


def instrument() -> Path:
    """The stamped copy's ``src`` directory."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch",
                    COPY / "src" / "repro_torch")
    cu = COPY / "src" / "repro_torch" / "kernels" / "csrc" / \
        "paged_attention.cu"
    s = cu.read_text()
    s = s.replace('#include "hopper.cuh"\n',
                  '#include "hopper.cuh"\n#include <cstdio>\n', 1)
    for anchor, text, before in STAMPS:
        if s.count(anchor) != 1:
            raise SystemExit(f"mla_decode_phases: decode_tc changed; "
                             f"{s.count(anchor)} lines {anchor!r}")
        s = s.replace(anchor, text + anchor if before else anchor + text)
    cu.write_text(s)
    return COPY / "src"


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv) or \
        ["--case", "1", "256", "1"]
    src = instrument()
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "mla_decode_bench.py"),
         "--src", str(src), "--tag", "stamped", *args],
        capture_output=True, text=True)
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
        return out.returncode
    phases: dict = {}
    merges: dict = {}
    for line in out.stdout.splitlines():
        m = re.match(r"decode_tc phases g (\d+) n (\d+): (.*)", line)
        if m:
            vals = dict(zip(m.group(3).split()[::2],
                            map(int, m.group(3).split()[1::2])))
            phases.setdefault((int(m.group(1)), int(m.group(2))),
                              []).append(vals)
        m = re.match(r"decode_tc merge ns (\d+): (\d+)", line)
        if m:
            merges.setdefault(int(m.group(1)), []).append(int(m.group(2)))
        elif line.startswith("stamped:"):
            print(line)
    for (g, n), runs in sorted(phases.items()):
        med = {k: statistics.median(r[k] for r in runs)
               for k in (*PHASES, "total")}
        print(f"decode_tc, warpgroup {g}, {n} tiles, median of {len(runs)} "
              f"calls, SM cycles: " + ", ".join(
                  f"{k} {med[k]:.0f} ({med[k] / med['total']:.0%})"
                  for k in PHASES) + f"; total {med['total']:.0f}")
    for ns, c in sorted(merges.items()):
        print(f"decode_tc merge of {ns} splits: median "
              f"{statistics.median(c):.0f} SM cycles over {len(c)} calls")
    return 0


if __name__ == "__main__":
    sys.exit(main())

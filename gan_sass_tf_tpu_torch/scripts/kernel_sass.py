"""Count the SASS instructions of the threefry kernels, by opcode.

    python -m gan_sass_tf_tpu_torch.scripts.kernel_sass [NAME ...]

Builds the kernels' library (`ops/build.py`), disassembles it with the
toolkit's `cuobjdump -sass` and, for each kernel function whose name holds
one of NAMEs (default `KERNELS`), counts its instructions as compiled
(static: an unrolled loop's body once per copy, a loop taken n times once)
by opcode, its 32-bit funnel-shift rotates (`SHF.L.W`: a threefry2x32
cipher has 20) and so its ciphers, and the instructions a cipher by the
pipe that issues them on Hopper as `ops/cost.py` counts them: the integer
ALU (IADD3, LOP3, SHF, ISETP, SEL, PRMT, LEA, ...) and the FMA pipe
(IMAD in all its forms, FFMA, FMUL, FADD).  Prints one JSON line, the card
and its power limit with it.  Needs the CUDA toolkit (a card's machine).
The file runs on an older checkout of the package too (`PYTHONPATH=that
tree python path/to/kernel_sass.py`), whose sources it builds.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from gan_sass_tf_tpu_torch.ops import build

KERNELS = ("threefry_dropout_kernel", "dropout_mask_kernel", "threefry_noise_kernel",
           "threefry_sample_kernel")
ALU = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IABS", "BMSK", "FLO",
       "POPC", "IMNMX", "VIADD", "VIMNMX", "SGXT", "BREV", "FSEL", "FSETP", "FMNMX"}
FMA = {"IMAD", "FFMA", "FMUL", "FADD", "IMUL"}
ROTATES_A_CIPHER = 20
_FUNCTION = re.compile(r"Function : (\S+)")
_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def functions(sass: str) -> dict:
    """{mangled kernel name: [opcodes in order]} of cuobjdump -sass's text."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _OPCODE.search(line)
        if name is not None and m:
            out[name].append(m.group(1))
    return out


def tally(opcodes) -> dict:
    """Counts of one function's instructions: by base opcode, rotates,
    ciphers, and a cipher's share of each pipe (the function's all over
    its ciphers)."""
    base = Counter(op.split(".")[0] for op in opcodes if op not in ("NOP",))
    rotates = sum(op.startswith("SHF.L.W") for op in opcodes)
    ciphers = rotates / ROTATES_A_CIPHER
    alu = sum(v for k, v in base.items() if k in ALU)
    fma = sum(v for k, v in base.items() if k in FMA)
    total = sum(base.values())
    per = (lambda v: v / ciphers if ciphers else None)
    return {"instructions": total, "rotates": rotates, "ciphers": ciphers,
            "alu": alu, "fma_pipe": fma, "other": total - alu - fma,
            "per_cipher": {"all": per(total), "alu": per(alu), "fma_pipe": per(fma)},
            "by_opcode": dict(base.most_common())}


def short(mangled: str) -> str:
    kind = ("<bf16>" if "__nv_bfloat16" in mangled
            else "<float>" if re.search(r"I[f]E", mangled) else "")
    return next((k for k in KERNELS if k in mangled), mangled) + kind


def disassemble(lib: Path) -> str:
    """cuobjdump -sass of a built library."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(KERNELS)
    lib = build.build()
    from gan_sass_tf_tpu_torch.scripts.profile_step import nvidia_smi

    found = {short(f): tally(ops) for f, ops in functions(disassemble(lib)).items()
             if any(n in f for n in names)}
    print(json.dumps({"nvidia_smi": nvidia_smi(), "library": lib.name,
                      "kernels": found}), flush=True)
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())

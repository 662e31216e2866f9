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
(IMAD in all its forms, FFMA, FMUL, FADD).  The same counts for its
`hot_block`, the basic block that holds the most rotates: a kernel whose
thread draws several values in one unrolled body (the noise's 16-byte
vector, the sampler's four values) counts there what a value of that body
pays, without its tail path or its set-up.  With each, its registers a
thread (`cuobjdump -res-usage`).  Prints one JSON line, the card and its
power limit with it.  Needs the CUDA toolkit (a card's machine).
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
_OPCODE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\bBRA\b[^;]*?(\.L_x_\d+|0x[0-9a-f]+)")
_ENDS_BLOCK = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET"}


def function_lines(sass: str) -> dict:
    """{mangled kernel name: [its lines of cuobjdump -sass's text]}."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def functions(sass: str) -> dict:
    """{mangled kernel name: [opcodes in order]} of cuobjdump -sass's text."""
    return {name: [m.group(2) for m in map(_OPCODE.search, lines) if m]
            for name, lines in function_lines(sass).items()}


def basic_blocks(lines) -> list:
    """A function's opcodes split into basic blocks: a block starts at a
    branch target (a label or a branched-to address) and ends after a
    branch, jump, exit or return."""
    targets = {t for line in lines for t in _TARGET.findall(line)}
    addresses = {int(t, 16) for t in targets if t.startswith("0x")}
    blocks, block = [], []
    for line in lines:
        label, m = _LABEL.search(line), _OPCODE.search(line)
        if block and (label and label.group(1) in targets
                      or m and int(m.group(1), 16) in addresses):
            blocks, block = blocks + [block], []
        if m:
            block.append(m.group(2))
            if m.group(2).split(".")[0] in _ENDS_BLOCK:
                blocks, block = blocks + [block], []
    return blocks + [block] if block else blocks


def hot_block(lines) -> list:
    """The opcodes of the basic block that holds the most rotates."""
    return max(basic_blocks(lines), key=lambda b: sum(op.startswith("SHF.L.W") for op in b),
               default=[])


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


SAMPLE_KINDS = ("bits", "uniform", "randint", "normal")   # the sampler's kind argument


def short(mangled: str) -> str:
    kind = re.search(r"threefry_sample_kernelILi(\d)ELj(\d+)E", mangled)
    kind = (f"<{SAMPLE_KINDS[int(kind.group(1))]}, {kind.group(2)}>" if kind
            else "<bf16>" if "__nv_bfloat16" in mangled
            else "<float>" if re.search(r"I[f]E", mangled) else "")
    return next((k for k in KERNELS if k in mangled), mangled) + kind


def disassemble(lib: Path) -> str:
    """cuobjdump -sass of a built library."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def registers(lib: Path) -> dict:
    """{mangled kernel name: registers a thread} from cuobjdump -res-usage."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-res-usage", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+?):?\s*$", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and name is not None:
            out[name], name = int(m.group(1)), None
    return out


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(KERNELS)
    lib = build.build()
    from gan_sass_tf_tpu_torch.scripts.profile_step import nvidia_smi

    regs = registers(lib)
    found = {short(f): {**tally([m.group(2) for m in map(_OPCODE.search, lines) if m]),
                        "registers": regs.get(f), "hot_block": tally(hot_block(lines))}
             for f, lines in function_lines(disassemble(lib)).items()
             if any(n in f for n in names)}
    print(json.dumps({"nvidia_smi": nvidia_smi(), "library": lib.name,
                      "kernels": found}), flush=True)
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())

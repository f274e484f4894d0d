"""AST contract rules on the port's tree (the port's counterpart of
``tools/check_contracts.py``): RNG discipline and kernel provenance, rules
no test can enforce because they are about code that does not exist yet or
about where code lives.

  CON-NPRANDOM    The legacy ``np.random.*`` global-state API (``seed``,
                  ``rand``, ``shuffle``, ...) is banned everywhere: the
                  checkpoints serialize ``default_rng`` states, and the
                  global RNG is invisible to them.  Use
                  ``np.random.default_rng(seed)``.

  CON-TORCHRNG    The counterpart of CON-PRNGKEY.  torch's global-state
                  RNG is banned everywhere: ``torch.manual_seed``,
                  ``torch.seed``, ``torch.cuda.manual_seed(_all)``, and
                  ``torch.rand`` / ``randn`` / ``randint`` / ``randperm``
                  / ``normal`` / ``bernoulli`` / ``multinomial`` and the
                  in-place samplers (``normal_``, ``uniform_``, ...)
                  without ``generator=``.  A fresh ``torch.Generator(...)``
                  may be made only at the init seams (``GENERATOR_SEAMS``):
                  the server and baseline constructors, the entry points
                  (launch, benchmarks, examples), the audit harness and
                  ``chip_smoke.py``; library code takes its generator, or
                  its seed, from them.

  CON-KERNEL-REF  Every kernel package ``kernels/<k>/`` ships a plain
                  ``ref.py`` and a ``tests/test_torch_*.py`` that imports
                  it: a kernel whose oracle is itself is not tested.

  CON-LOAD-SEAM   The counterpart of CON-INTERPRET: a compiled library is
                  loaded in one place, ``kernels/build.py`` (``ctypes.CDLL``
                  nowhere else), and every function of a kernel wrapper
                  that launches (``_launch(...)``, or the bound entry point
                  ``_fwd(...)``) calls ``check_kernel_inputs`` before it,
                  so that a CPU tensor never reaches a CUDA kernel and the
                  plain version is taken only on the CPU.

Waive a finding on its line with ``# contracts: allow=RULE`` (several:
comma-separated).  Exit 1 on any un-waived finding.

Run: ``python -m repro_torch.analysis --contracts`` (or ``python -m
repro_torch.analysis.contracts [--root .]``).
"""
from __future__ import annotations

import argparse
import ast
import pathlib
import re
import sys
from typing import List

# init seams where making a torch.Generator is the point (relative to the
# repository root; a directory covers its files)
GENERATOR_SEAMS = (
    "src/repro_torch/federated/server.py",     # NeuLiteServer(seed)
    "src/repro_torch/federated/baselines.py",  # baseline constructors
    "src/repro_torch/launch/",                 # train / serve entry points
    "src/repro_torch/benchmarks/",             # benchmark entry points
    "src/repro_torch/examples/",               # example entry points
    "src/repro_torch/analysis/harness.py",     # the audit models
    "chip_smoke.py",
)

LEGACY_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence",
                       "BitGenerator", "PCG64", "Philox"}
TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed",
                     "torch.random.manual_seed", "torch.random.seed",
                     "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                     "torch.cuda.seed", "torch.cuda.seed_all"}
TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                  "bernoulli", "multinomial", "poisson", "rand_like",
                  "randn_like", "randint_like"}
INPLACE_SAMPLERS = {"normal_", "uniform_", "random_", "bernoulli_",
                    "exponential_", "geometric_", "log_normal_", "cauchy_"}
LAUNCH_CALLS = {"_launch", "_fwd"}      # the kernel wrappers' launch seams
LOAD_SEAM = "src/repro_torch/kernels/build.py"

_ALLOW_RE = re.compile(r"#\s*contracts:\s*allow=([\w,-]+)")


class Finding:
    def __init__(self, rule, path, line, message):
        self.rule, self.path, self.line, self.message = \
            rule, path, line, message

    def render(self):
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def _allowed(lines, lineno, rule) -> bool:
    if 1 <= lineno <= len(lines):
        m = _ALLOW_RE.search(lines[lineno - 1])
        if m and rule in m.group(1).split(","):
            return True
    return False


def _attr_chain(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _in_seam(rel: str) -> bool:
    return any(rel == s or (s.endswith("/") and rel.startswith(s))
               for s in GENERATOR_SEAMS)


def _has_generator(node: ast.Call) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


def _rng_findings(node: ast.Call, rel: str, lines) -> List[Finding]:
    chain = _attr_chain(node.func)
    parts = chain.split(".")
    out = []

    def add(rule, message):
        if not _allowed(lines, node.lineno, rule):
            out.append(Finding(rule, rel, node.lineno, message))

    if (len(parts) >= 3 and parts[0] in ("np", "numpy")
            and parts[1] == "random" and parts[2] not in LEGACY_NP_RANDOM_OK):
        add("CON-NPRANDOM",
            f"legacy global-state RNG call '{chain}': use "
            f"np.random.default_rng(seed) so the RNG state is "
            f"checkpointable and import-order independent")
    if chain in TORCH_GLOBAL_SEED:
        add("CON-TORCHRNG",
            f"'{chain}' sets torch's global RNG: draw from a "
            f"torch.Generator made at an init seam instead")
    elif (len(parts) == 2 and parts[0] == "torch"
          and parts[1] in TORCH_SAMPLERS and not _has_generator(node)):
        add("CON-TORCHRNG",
            f"'{chain}' without generator= draws from torch's global RNG, "
            f"which no checkpoint holds: pass the seam's generator")
    elif (parts[-1] in INPLACE_SAMPLERS and len(parts) >= 2
          and not _has_generator(node)):
        add("CON-TORCHRNG",
            f"'{chain}' without generator= draws from torch's global RNG: "
            f"pass the seam's generator")
    if chain == "torch.Generator" and not _in_seam(rel):
        add("CON-TORCHRNG",
            f"torch.Generator made outside an init seam: take it (or the "
            f"seed) from the caller (seams: "
            f"{', '.join(GENERATOR_SEAMS)})")
    return out


def _load_findings(tree, rel: str, lines) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and _attr_chain(node.func) in ("ctypes.CDLL", "CDLL")
                and rel != LOAD_SEAM
                and not _allowed(lines, node.lineno, "CON-LOAD-SEAM")):
            out.append(Finding(
                "CON-LOAD-SEAM", rel, node.lineno,
                f"ctypes.CDLL outside {LOAD_SEAM}: load a library through "
                f"kernels.build.load_library, which builds it from its "
                f"source first"))
    if not re.fullmatch(r"src/repro_torch/kernels/\w+/kernel\.py", rel):
        return out
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name in LAUNCH_CALLS:
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        launches = [n.lineno for n in calls
                    if isinstance(n.func, ast.Name)
                    and n.func.id in LAUNCH_CALLS]
        checks = [n.lineno for n in calls
                  if _attr_chain(n.func).endswith("check_kernel_inputs")]
        if launches and not (checks and min(checks) < min(launches)):
            line = min(launches)
            if not _allowed(lines, line, "CON-LOAD-SEAM"):
                out.append(Finding(
                    "CON-LOAD-SEAM", rel, line,
                    f"{fn.name} launches a kernel without calling "
                    f"check_kernel_inputs first: a CPU tensor or a wrong "
                    f"dtype would reach the CUDA kernel"))
    return out


def check_file(path: pathlib.Path, rel: str) -> List[Finding]:
    source = path.read_text()
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [Finding("CON-SYNTAX", rel, e.lineno or 0, str(e.msg))]
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            findings.extend(_rng_findings(node, rel, lines))
    findings.extend(_load_findings(tree, rel, lines))
    return findings


def check_kernel_refs(root: pathlib.Path) -> List[Finding]:
    findings = []
    kdir = root / "src" / "repro_torch" / "kernels"
    if not kdir.is_dir():
        return findings
    test_text = "\n".join(
        p.read_text() for p in (root / "tests").glob("test_torch_*.py"))
    for pkg in sorted(kdir.iterdir()):
        if not pkg.is_dir() or not (pkg / "kernel.py").exists():
            continue
        rel = f"src/repro_torch/kernels/{pkg.name}"
        if not (pkg / "ref.py").exists():
            findings.append(Finding(
                "CON-KERNEL-REF", f"{rel}/kernel.py", 1,
                f"kernel package '{pkg.name}' has no ref.py: every kernel "
                f"needs a plain PyTorch oracle"))
            continue
        if not re.search(
                rf"repro_torch\.kernels\.{pkg.name}\.ref\b"
                rf"|repro_torch\.kernels\.{pkg.name} import [^\n]*\bref\b",
                test_text):
            findings.append(Finding(
                "CON-KERNEL-REF", f"{rel}/ref.py", 1,
                f"no tests/test_torch_*.py imports "
                f"repro_torch.kernels.{pkg.name}.ref: add a test holding "
                f"the kernel against its oracle"))
    return findings


def port_files(root: pathlib.Path) -> List[pathlib.Path]:
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    smoke = root / "chip_smoke.py"
    return files + ([smoke] if smoke.exists() else [])


def run(root) -> List[Finding]:
    root = pathlib.Path(root).resolve()
    findings = []
    for path in port_files(root):
        findings.extend(check_file(path, str(path.relative_to(root))))
    findings.extend(check_kernel_refs(root))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parents[3]),
        help="repository root (holds src/ and tests/)")
    args = ap.parse_args(argv)
    findings = run(args.root)
    for f in findings:
        print(f.render())
    print(f"{'FAIL' if findings else 'OK'}: {len(findings)} contract "
          f"finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

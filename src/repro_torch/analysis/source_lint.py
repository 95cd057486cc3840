"""Repo-specific AST lint rules for the port's backend-stack contracts.

Reads the port's Python source (``src/repro_torch`` and ``chip_smoke.py``)
with :mod:`ast`, as the reference's pass reads its own tree; the framework
(per-file visitor, import resolution, pragmas, test paths exempt) is the
reference's, and the rules are aimed at PyTorch idiom.  Five rules:

* ``registry-mutation`` — the ``repro_torch.core.gemm_sims`` design
  registry may only be mutated through ``scoped_registry`` /
  ``kernel_backends`` scopes (or in ``core/gemm_sims.py`` itself, which
  registers the built-ins).  Unscoped mutation leaks designs across tests
  and benchmark snapshots.
* ``deprecated-shim`` — the string-dispatch shims (``gemm_sims.gemm`` /
  ``stream_gemm`` / ``gemm_batched`` and
  ``kernels.backends.register_kernel_backends``) are for tests and
  back-compat only; production paths construct backends with
  ``repro_torch.backends.resolve``.
* ``global-rng`` (the reference's ``unjitted-rng``, which has no PyTorch
  meaning: eager PyTorch jits nothing) — a ``torch.rand*`` / ``randn*`` /
  ``randint*`` / ``randperm`` / ``bernoulli`` / ``multinomial`` /
  ``normal`` / ``poisson`` call, or an in-place sampler such as
  ``Tensor.normal_``, on the execute path (``repro_torch/backends``,
  ``repro_torch/kernels``, ``repro_torch/serving``) that passes no
  ``generator=`` draws from the process-global generator, so a result
  depends on whatever ran before it: the port's contract is explicit
  random generators.
* ``float-accumulation`` — PyTorch has no ``preferred_element_type``, so a
  ``torch.matmul`` / ``mm`` / ``bmm`` / ``einsum`` / ``tensordot`` /
  ``linear`` / ``addmm`` call (function or method) or an ``@`` inside an
  exact-design function (name prefixed ``bgemm`` / ``tugemm`` /
  ``tubgemm`` / ``tu_gemm`` / ``tub_gemm`` / ``quant_gemm`` /
  ``fused_paged`` / ``_fused_decode``) is flagged: its sums would be float
  unless a ``# analysis: allow-float-accumulation (why it is exact)``
  pragma says otherwise.  ``torch._int_mm`` accumulates in int32 and is
  never flagged.
* ``packed-materialize`` — ``kernels/packed_gemm.py``'s execute paths
  exist so the dequantized weight matrix never materializes; a
  ``dequantize(...)`` call there reverts the fused kernel to a
  materialize-then-contract path.

Suppression: a ``# analysis: allow-<rule>`` comment on the flagged line or
on the enclosing ``def`` line disables that rule there.  Test trees are
skipped entirely.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterable

from repro_torch.analysis.findings import ERROR, Finding

RULES = ("registry-mutation", "deprecated-shim", "global-rng",
         "float-accumulation", "packed-materialize")

_PRAGMA_RE = re.compile(r"#\s*analysis:\s*allow-([a-z0-9-]+)")

#: Deprecated string-dispatch surface: module -> function names.
DEPRECATED_SHIMS = {
    "repro_torch.core.gemm_sims": {"gemm", "stream_gemm", "gemm_batched"},
    "repro_torch.kernels.backends": {"register_kernel_backends"},
}
_REGISTRY_MODULE = "repro_torch.core.gemm_sims"
_REGISTRY_MUTATORS = {"register_design", "registry_restore"}
_SCOPE_MANAGERS = {"scoped_registry", "kernel_backends"}

_EXECUTE_PATH_PARTS = ("repro_torch/backends/", "repro_torch/kernels/",
                       "repro_torch/serving/")
_PACKED_KERNEL_PARTS = ("kernels/packed_gemm",)
_EXACT_KERNEL_PREFIXES = ("bgemm", "tugemm", "tubgemm", "tu_gemm",
                          "tub_gemm", "quant_gemm",
                          "fused_paged", "_fused_decode")
_CONTRACTION_FUNCS = {"matmul", "mm", "bmm", "einsum", "tensordot",
                      "linear", "addmm"}
#: ``torch.<name>`` samplers that take a ``generator=``
_RNG_FUNCS = {"rand", "rand_like", "randn", "randn_like", "randint",
              "randint_like", "randperm", "bernoulli", "multinomial",
              "normal", "poisson"}
#: in-place samplers of a tensor, any receiver
_RNG_METHODS = {"normal_", "uniform_", "bernoulli_", "random_",
                "exponential_", "geometric_", "log_normal_", "cauchy_"}

#: Files whose job is to define the things the rules police.
_DEFINING_FILES = {
    "registry-mutation": ("src/repro_torch/core/gemm_sims.py",),
    "deprecated-shim": ("src/repro_torch/core/gemm_sims.py",
                        "src/repro_torch/kernels/backends.py"),
}


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` attribute chains as a dotted string (None otherwise)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _FileLint(ast.NodeVisitor):
    def __init__(self, rel: str, source: str):
        self.rel = rel
        self.findings: list[Finding] = []
        self.pragmas: dict[int, set[str]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            for m in _PRAGMA_RE.finditer(line):
                self.pragmas.setdefault(i, set()).add(m.group(1))
        # import resolution: alias -> module path, name -> (module, attr)
        self.module_alias: dict[str, str] = {}
        self.from_import: dict[str, tuple[str, str]] = {}
        self.func_stack: list[ast.AST] = []
        self.scope_with_depth = 0  # inside `with ...scoped_registry():`
        self.in_execute_path = any(p in rel for p in _EXECUTE_PATH_PARTS)

    # -- plumbing ---------------------------------------------------------
    def _allowed(self, rule: str, line: int) -> bool:
        if rule in self.pragmas.get(line, ()):
            return True
        return any(rule in self.pragmas.get(f.lineno, ())
                   for f in self.func_stack)

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        if self._allowed(rule, node.lineno):
            return
        self.findings.append(Finding(
            pass_name="source-lint", rule=rule, severity=ERROR,
            where=f"{self.rel}:{node.lineno}", message=message))

    def _resolve(self, chain: str) -> str:
        """Expand the chain's leading alias to its imported module path."""
        head, _, rest = chain.partition(".")
        base = self.module_alias.get(head)
        if base is not None:
            return f"{base}.{rest}" if rest else base
        return chain

    def _exempt(self, rule: str) -> bool:
        return self.rel in _DEFINING_FILES.get(rule, ())

    # -- imports ----------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.asname:
                self.module_alias[alias.asname] = alias.name
            else:
                top = alias.name.partition(".")[0]
                self.module_alias.setdefault(top, top)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for alias in node.names:
            bound = alias.asname or alias.name
            self.from_import[bound] = (mod, alias.name)
            self.module_alias[bound] = f"{mod}.{alias.name}"
        self.generic_visit(node)

    # -- structure --------------------------------------------------------
    def _visit_func(self, node) -> None:
        self.func_stack.append(node)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_With(self, node: ast.With) -> None:
        scoped = any(
            isinstance(item.context_expr, ast.Call)
            and (_dotted(item.context_expr.func) or "").rpartition(".")[2]
            in _SCOPE_MANAGERS
            for item in node.items)
        self.scope_with_depth += scoped
        self.generic_visit(node)
        self.scope_with_depth -= scoped

    # -- the rules --------------------------------------------------------
    def _call_target(self, node: ast.Call) -> tuple[str, str] | None:
        """(module, function) a call resolves to, best-effort."""
        if isinstance(node.func, ast.Name):
            return self.from_import.get(node.func.id)
        chain = _dotted(node.func)
        if chain is None:
            return None
        mod, _, fn = self._resolve(chain).rpartition(".")
        return (mod, fn) if mod else None

    def visit_Call(self, node: ast.Call) -> None:
        target = self._call_target(node)
        if target is not None:
            mod, fn = target
            if mod in DEPRECATED_SHIMS and fn in DEPRECATED_SHIMS[mod] \
                    and not self._exempt("deprecated-shim"):
                self._flag(
                    "deprecated-shim", node,
                    f"call to deprecated {mod}.{fn}; construct backends "
                    f"with repro_torch.backends.resolve instead")
            if mod == _REGISTRY_MODULE and fn in _REGISTRY_MUTATORS \
                    and not self.scope_with_depth \
                    and not self._exempt("registry-mutation"):
                self._flag(
                    "registry-mutation", node,
                    f"{fn} mutates the global design registry outside a "
                    f"scoped_registry/kernel_backends scope — leaked "
                    f"registrations outlive the caller")
        if self.in_execute_path:
            self._check_rng(node, target)
        self._check_accumulation(node)
        self._check_packed_materialize(node)
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.MatMult):
            self._flag_accumulation(node, "@")
        self.generic_visit(node)

    def _check_rng(self, node: ast.Call, target) -> None:
        if any(kw.arg == "generator" for kw in node.keywords):
            return
        if target is not None and target[0] == "torch" \
                and target[1] in _RNG_FUNCS:
            what = f"torch.{target[1]}"
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _RNG_METHODS:
            what = f".{node.func.attr}"
        else:
            return
        self._flag(
            "global-rng", node,
            f"{what} on the execute path without generator= — draws from "
            f"the process-global generator, so the result depends on what "
            f"ran before it")

    def _in_exact_kernel(self) -> str | None:
        for f in reversed(self.func_stack):
            name = getattr(f, "name", "")
            if name.startswith(_EXACT_KERNEL_PREFIXES):
                return name
        return None

    def _flag_accumulation(self, node: ast.AST, what: str) -> None:
        kernel = self._in_exact_kernel()
        if kernel is None:
            return
        self._flag(
            "float-accumulation", node,
            f"{what} in exact-design function {kernel!r} — PyTorch float "
            f"matmuls sum in float, voiding the bit-exactness claim unless "
            f"the sums are shown exact (allow-float-accumulation pragma "
            f"with the reason) or the product is torch._int_mm")

    def _check_accumulation(self, node: ast.Call) -> None:
        chain = _dotted(node.func)
        if chain is None and isinstance(node.func, ast.Attribute):
            chain = node.func.attr           # a method of an expression
        fn = (chain or "").rpartition(".")[2]
        if fn in _CONTRACTION_FUNCS:
            self._flag_accumulation(node, fn)

    def _check_packed_materialize(self, node: ast.Call) -> None:
        if not any(p in self.rel for p in _PACKED_KERNEL_PARTS):
            return
        chain = _dotted(node.func) or ""
        if chain.rpartition(".")[2] != "dequantize":
            return
        self._flag(
            "packed-materialize", node,
            "dequantize(...) inside the packed-GEMM kernel module — the "
            "fused execute path must contract int32-word tiles directly; "
            "materializing the dequantized matrix reverts the packed "
            "store's HBM-traffic saving")

    def _registry_store(self, node: ast.AST) -> None:
        chain = _dotted(node) or (node.id if isinstance(node, ast.Name)
                                  else "")
        if isinstance(node, ast.Subscript):
            chain = _dotted(node.value) or ""
        if self._resolve(chain).rpartition(".")[2] == "_REGISTRY" \
                and not self.scope_with_depth \
                and not self._exempt("registry-mutation"):
            self._flag(
                "registry-mutation", node,
                "direct write to gemm_sims._REGISTRY — use "
                "register_design under a scoped_registry scope")

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._registry_store(tgt)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._registry_store(node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._registry_store(tgt)
        self.generic_visit(node)


def lint_source(source: str, *, rel: str = "<memory>") -> list[Finding]:
    """Lint one file's text (unit-test entry point)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(pass_name="source-lint", rule="syntax-error",
                        severity=ERROR, where=f"{rel}:{e.lineno or 0}",
                        message=str(e))]
    lint = _FileLint(rel, source)
    lint.visit(tree)
    return lint.findings


def _is_test_path(rel: str) -> bool:
    parts = pathlib.PurePosixPath(rel).parts
    return any(p in ("tests", "test") or p.startswith("test_")
               for p in parts)


def iter_python_files(root: pathlib.Path,
                      subdirs: Iterable[str]) -> Iterable[pathlib.Path]:
    for sub in subdirs:
        base = root / sub
        if base.is_file() and base.suffix == ".py":
            yield base
            continue
        if not base.is_dir():
            continue
        for p in sorted(base.rglob("*.py")):
            if "__pycache__" in p.parts:
                continue
            yield p


def lint_repo(root, subdirs: Iterable[str] = ("src/repro_torch",
                                              "chip_smoke.py")
              ) -> list[Finding]:
    """Lint every non-test python file under the given repo subtrees."""
    root = pathlib.Path(root)
    findings: list[Finding] = []
    for path in iter_python_files(root, subdirs):
        rel = path.relative_to(root).as_posix()
        if _is_test_path(rel):
            continue
        findings.extend(lint_source(path.read_text(), rel=rel))
    return findings

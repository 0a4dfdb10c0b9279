"""The port's API inventory against nle_tpu's, read from both packages'
sources with ast (neither package is imported).

Every public top-level function and class of nle_tpu/**.py has a
same-named counterpart in the port's mirrored module (ops/pallas/ ->
ops/kernels/), or stands in ACCOUNTED with its counterpart elsewhere or the
reason it has none. Every name in a subpackage's __all__ is in the port's
counterpart's __all__ (under its ACCOUNTED name where it was renamed) and
bound in that __init__."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "nle_tpu")
PORT_DIR = os.path.join(ROOT, "nle_tpu_torch")

LEFT_BEHIND = "left behind (TPU-only)"

# "nle_tpu module:name" -> "renamed to <port module>:<name>" or
# LEFT_BEHIND.
ACCOUNTED = {
    "config.py:default_eps": "renamed to config.py:EPS",
    "config.py:enable_persistent_cache": LEFT_BEHIND,
    "ops/affinity.py:affinity_matmul_xla":
        "renamed to ops/kernels/affinity_kernel.py:affinity_matmul_plain",
    # The port builds the pieces in float64 on the host (the kept-rank
    # repair of the factored route).
    "ops/pipeline.py:factored_filter_pieces":
        "renamed to ops/pipeline.py:factored_pieces64",
    "ops/pipeline.py:resolve_sb_tri": LEFT_BEHIND,
    "ops/pipeline.py:submit_sb_fetch": LEFT_BEHIND,
    "ops/pipeline.py:train_filter_stage2b_edit":
        "renamed to ops/pipeline.py:_stage2_outputs",
    "ops/pipeline.py:train_filter_stage2b_streaming_edit":
        "renamed to ops/pipeline.py:_stage2_outputs",
    "ops/precision.py:dot_general_3pass": LEFT_BEHIND,
    "ops/precision.py:split_bf16": LEFT_BEHIND,
    "ops/precision.py:stage2_dots": LEFT_BEHIND,
    "ops/precision.py:stage2_gram": LEFT_BEHIND,
    "ops/precision.py:stage2_matmul": LEFT_BEHIND,
    "ops/pallas/affinity_kernel.py:affinity_matmul_pallas":
        "renamed to ops/kernels/affinity_kernel.py:affinity_matmul_kernel",
    "ops/pallas/affinity_kernel.py:ptiled_fits": LEFT_BEHIND,
    "ops/pallas/scaled_matmul_kernel.py:gram_tile": LEFT_BEHIND,
    # Also stage2_dense_small's VMEM clause: the port's predicate keeps
    # only its NLE_CPHI_BYTES clause.
    "ops/pallas/scaled_matmul_kernel.py:scaled_fits_vmem": LEFT_BEHIND,
    "ops/pallas/scaled_matmul_kernel.py:scaled_gram_pallas":
        "renamed to ops/kernels/scaled_matmul_kernel.py:scaled_gram",
    "ops/pallas/scaled_matmul_kernel.py:scaled_matmul_pallas":
        "renamed to ops/kernels/scaled_matmul_kernel.py:scaled_matmul",
    "ops/pallas/sinkhorn_kernel.py:pack_pairs_int32": LEFT_BEHIND,
    "ops/pallas/sinkhorn_kernel.py:quantize_pack_int16":
        "renamed to ops/kernels/sinkhorn_kernel.py:quantize_int16",
    "ops/pallas/sinkhorn_kernel.py:sinkhorn_halfstep_manual":
        "renamed to ops/kernels/sinkhorn_kernel.py:sinkhorn_halfstep",
    "ops/pallas/sinkhorn_kernel.py:sinkhorn_halfstep_pallas":
        "renamed to ops/kernels/sinkhorn_kernel.py:sinkhorn_halfstep_tiled",
    "ops/pallas/sinkhorn_kernel.py:sinkhorn_halfstep_split_xla":
        "renamed to ops/kernels/sinkhorn_kernel.py:sinkhorn_halfstep_plain",
    "ops/pallas/streaming_kernel.py:gram_fits_vmem": LEFT_BEHIND,
    "ops/pallas/streaming_kernel.py:stream_p_alignment": LEFT_BEHIND,
    "ops/pallas/streaming_kernel.py:streaming_ap_pallas":
        "renamed to ops/kernels/streaming_kernel.py:streaming_ap",
    "ops/pallas/streaming_kernel.py:streaming_atb_pallas":
        "renamed to ops/kernels/streaming_kernel.py:streaming_atb",
    "ops/pallas/streaming_kernel.py:streaming_halfstep_pallas":
        "renamed to ops/kernels/streaming_kernel.py:streaming_halfstep",
    "ops/pallas/streaming_kernel.py:streaming_halfstep_ptiled_pallas":
        "renamed to ops/kernels/streaming_kernel.py:"
        "streaming_halfstep_ptiled",
    "ops/pallas/streaming_kernel.py:streaming_scaled_gram_pallas":
        "renamed to ops/kernels/streaming_kernel.py:streaming_scaled_gram",
    "ops/pallas/streaming_kernel.py:streaming_scaled_gram_xla":
        "renamed to ops/kernels/streaming_kernel.py:"
        "streaming_scaled_gram_plain",
    "utils/transfer.py:fetch": LEFT_BEHIND,
    "utils/transfer.py:transfer_pool": LEFT_BEHIND,
}
RENAMED = "renamed to "


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_DIR):
        out += [os.path.relpath(os.path.join(dirpath, f), JAX_DIR)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _port_path(rel: str) -> str:
    return os.path.join(PORT_DIR, rel.replace("ops/pallas/", "ops/kernels/"))


def _tree(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read(), path)


def _public_defs(tree: ast.Module) -> set:
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _bound(tree: ast.Module) -> set:
    """Every top-level name the module binds (defs, classes, assignments,
    imports), and the names a module __getattr__ serves lazily."""
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            names.add(n.name)
            if n.name == "__getattr__":
                names |= {c.value for c in ast.walk(n)
                          if isinstance(c, ast.Constant)
                          and isinstance(c.value, str)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
    return names


def _all(tree: ast.Module) -> list | None:
    for n in tree.body:
        if (isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in n.targets)):
            return list(ast.literal_eval(n.value))
    return None


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_has_a_counterpart(rel):
    names = _public_defs(_tree(os.path.join(JAX_DIR, rel)))
    port = _port_path(rel)
    have = _bound(_tree(port)) if os.path.exists(port) else set()
    for name in sorted(names):
        key = f"{rel}:{name}"
        verdict = ACCOUNTED.get(key)
        if verdict is None:
            assert name in have, (
                f"nle_tpu/{key} has no counterpart in "
                f"{os.path.relpath(port, ROOT)} and no ACCOUNTED entry")
            continue
        # An entry stands only for a name the mirrored module lacks.
        assert name not in have, f"{key} is ported: drop its ACCOUNTED entry"
        if verdict.startswith(RENAMED):
            mod, new = verdict[len(RENAMED):].split(":")
            assert new in _bound(_tree(os.path.join(PORT_DIR, mod))), (
                f"{key}: {verdict} not found")
        else:
            assert verdict == LEFT_BEHIND, (key, verdict)


def test_accounted_names_exist_in_nle_tpu():
    for key in ACCOUNTED:
        rel, name = key.split(":")
        assert name in _public_defs(_tree(os.path.join(JAX_DIR, rel))), key


@pytest.mark.parametrize("rel", [
    m for m in _jax_modules() if m.endswith("__init__.py")
    and _all(_tree(os.path.join(JAX_DIR, m))) is not None])
def test_subpackage_exports(rel):
    names = _all(_tree(os.path.join(JAX_DIR, rel)))
    port = _tree(_port_path(rel))
    exported, bound = _all(port) or [], _bound(port)
    package = os.path.dirname(rel)
    for name in names:
        # An exported name's module is the one whose def the __init__
        # imports; a rename in ACCOUNTED under any module of the package
        # gives the port's name.
        renamed = [v[len(RENAMED):].split(":")[1]
                   for k, v in ACCOUNTED.items()
                   if k.endswith(f":{name}") and v.startswith(RENAMED)
                   and os.path.dirname(k.split(":")[0]) == package]
        want = renamed[0] if renamed else name
        assert want in exported, f"nle_tpu/{rel} exports {name}; the port's "\
            f"__all__ lacks {want}"
        assert want in bound, f"{want} is in the port's __all__ but unbound"

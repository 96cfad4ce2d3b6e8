"""fastsk_tpu_torch's KernelConfig against fastsk_tpu's, on the CPU.

The port takes every field of the JAX package's dataclass, so a config
written for one package builds the other's: each field at its default
and at another value (under the exact engine where that value acts) gives
counts equal to the JAX package's from the same fields, and to
tests/oracle.py's. Counts are integers: the tolerance is equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

import fastsk_tpu as J
import fastsk_tpu_torch as T
from fastsk_tpu.kernel.engine import DenseGkmEngine as JDense
from fastsk_tpu_torch.kernel.engine import DenseGkmEngine as TDense
from fastsk_tpu_torch.ops import gkm as tgkm
from fastsk_tpu_torch.ops.encode import encode_sequences

import oracle

JAX_FIELDS = [f.name for f in dataclasses.fields(J.KernelConfig)]
# the fields that hold JAX objects (a jax Mesh, a jax Device) at any value
# but their default None: the port takes its own mesh
# (parallel/sharding.py:make_mesh) and a torch device there
JAX_OBJECTS = ("mesh", "device")

# each other field: a value other than its default, and the exact engine
# under which it acts ("sorted": the theta engine past b_max_dense). The
# JAX package runs its Pallas kernels on the CPU only in interpret mode,
# which the port refuses, so pairs_backend is taken under the
# sequence-aligned engine, which runs kernel A in both backends.
OTHER = {
    "b_max_dense": (32, "theta"),  # 4**3 buckets pass it: the sorted engine
    "counts_budget_bytes": (1 << 10, "theta"),  # one theta a batch
    "onehot_budget_bytes": (1 << 12, "theta"),  # row chunks of 8
    "max_theta_batch": (2, "theta"),
    "theta_batch": (3, "theta"),
    "row_chunk": (5, "theta"),
    "mesh_state": ("replicated", "packed"),
    "exact_engine": ("packed", None),
    "pairs_backend": ("pallas_grouped", "pairs"),
    "sorted_slab": (16, "sorted"),
    "sorted_layout": ("pairs", "sorted"),
    "sorted_run_width": (8, "sorted"),
    "checkpoint_path": ("ckpt.npz", "theta"),
    "checkpoint_every": (2, "theta"),  # with a checkpoint_path
    "device_resident": (True, "pairs"),
    "profile_dir": ("trace", "pairs"),
    "quiet": (False, "theta"),
}

G, M = 5, 2


def _seqs():
    rng = np.random.default_rng(14)
    return [rng.integers(1, 5, size=int(rng.integers(20, 31))).tolist() for _ in range(10)]


def _jax_config(field, at, root):
    value, engine = OTHER[field]
    fields = {}
    if engine == "sorted":
        fields.update(exact_engine="theta", b_max_dense=32)
    elif engine is not None:
        fields["exact_engine"] = engine
    if at == "other":
        if field in ("checkpoint_path", "checkpoint_every"):
            fields["checkpoint_path"] = str(root / "ckpt.npz")
        fields[field] = str(root / value) if field in ("checkpoint_path", "profile_dir") else value
    root.mkdir()
    return J.KernelConfig(**fields)


def test_other_covers_every_field():
    assert set(OTHER) | set(JAX_OBJECTS) == set(JAX_FIELDS)
    assert all(getattr(J.KernelConfig(), f) is None for f in JAX_OBJECTS)


@pytest.mark.parametrize("at", ["default", "other"])
@pytest.mark.parametrize("field", sorted(OTHER))
def test_port_takes_every_jax_field(tmp_path, field, at):
    """The port's config built from every field of a JAX config (on the
    CPU: device="cpu" in place of JAX's None) holds the same values and
    gives the JAX package's counts."""
    X = _seqs()
    jcfg = _jax_config(field, at, tmp_path / "jax")
    if at == "other":
        assert getattr(jcfg, field) != getattr(J.KernelConfig(), field)
    # the port's own paths, so neither package resumes the other's checkpoint
    tsrc = _jax_config(field, at, tmp_path / "torch")
    tfields = {f: getattr(tsrc, f) for f in JAX_FIELDS}
    assert tfields.pop("mesh") is None and tfields.pop("device") is None
    tcfg = T.KernelConfig(**tfields, device="cpu")
    assert all(getattr(tcfg, f) == v for f, v in tfields.items())
    got, want = T.FastSK(G, M, config=tcfg), J.FastSK(G, M, config=jcfg)
    for fsk in (got, want):
        fsk.compute_kernel(X[:8], X[8:])
    np.testing.assert_array_equal(got.kernel_counts, want.kernel_counts)
    np.testing.assert_array_equal(got.kernel_counts, oracle.exact_counts(X, G, M))


def test_device_none_is_the_card():
    """JAX's device=None (the default backend) is the card in the port, as
    its default "cuda"; nothing is resolved until an engine runs."""
    assert T.KernelConfig(device=None).device == torch.device("cuda")
    with pytest.raises(ValueError, match="sorted_layout"):
        T.KernelConfig(sorted_layout="slabs", device="cpu")


@pytest.mark.parametrize("onehot,hashed", [(1 << 30, 1 << 30), (1 << 22, 1 << 30), (1 << 22, 1 << 21)])
def test_dense_row_chunk_takes_the_smaller_budget(onehot, hashed):
    """The dense engine's row chunk is the smaller of the port's hash chunk
    and the JAX package's one-hot chunk (the same f32 product dtype on the
    CPU past 256 windows a sequence)."""
    rng = np.random.default_rng(3)
    enc = encode_sequences([rng.integers(1, 5, size=300).tolist() for _ in range(40)])
    j = JDense(enc, 8, 4, J.KernelConfig(onehot_budget_bytes=onehot))
    t = TDense(enc, 8, 4, T.KernelConfig(device="cpu", onehot_budget_bytes=onehot,
                                         hash_budget_bytes=hashed))
    assert t.theta_batch == j.theta_batch and t.matmul_dtype == torch.float32
    hash_rows = max(1, min(t.n, hashed // (t.p * t.theta_batch * tgkm.HASH_BYTES)))
    assert t.row_chunk == min(hash_rows, j.row_chunk)
    assert t.row_chunk < t.n if onehot < 1 << 30 else t.row_chunk == t.n

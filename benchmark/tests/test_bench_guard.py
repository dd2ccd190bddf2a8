"""The run's module guard compares whole top-level names."""

from benchmark.guard import forbidden_modules


def test_jax_and_the_jax_package_trip_it():
    assert forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert forbidden_modules(["jaxlib.xla_client"]) == ["jaxlib.xla_client"]
    assert forbidden_modules(["style_seqcvae_tpu", "style_seqcvae_tpu.ops.topk"]) == \
        ["style_seqcvae_tpu", "style_seqcvae_tpu.ops.topk"]
    assert forbidden_modules(["flax.linen"]) == ["flax.linen"]


def test_the_port_does_not():
    assert forbidden_modules(["style_seqcvae_tpu_torch", "style_seqcvae_tpu_torch.serving",
                              "jaxtyping", "torch"]) == []

"""CRUSH placement: the data model, the scalar mapper and the batched one.

Copies of the JAX package's framework-free modules (types, hash, ln_tables,
mapper, builder, compiler, tree), with their imports rewired; the batched
mapper `torch_mapper` (counterpart of jax_mapper, over the straw2 choose
kernel of csrc/crush_choose.cu); and the `crushtool --test` engine `tester`.
"""

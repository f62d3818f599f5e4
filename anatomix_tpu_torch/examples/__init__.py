"""The port's runnable tutorials, the counterparts of the JAX package's
`examples/` scripts on the port's own modules. Each runs as a module and
defaults to the card (`--device cpu` for the plain PyTorch path):

    python -m anatomix_tpu_torch.examples.feature_extraction_and_registration
    python -m anatomix_tpu_torch.examples.fewshot_segmentation
    python -m anatomix_tpu_torch.examples.synthgen_and_pretraining

Importing them does no work.
"""

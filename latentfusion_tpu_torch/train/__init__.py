"""Training (counterpart of ``latentfusion_tpu/train``): the reconstruction
step (``step.py``), the IBR generator's step (``ibr_step.py``), the epoch
loop and checkpoints (``trainer.py``), the tools' flags (``args.py``) and
the meters (``logging.py``)."""

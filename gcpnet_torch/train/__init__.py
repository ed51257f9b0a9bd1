"""Training: optimizers and schedules, the train state with its gradient-norm
ring, and the train step (bf16 compute over float32 masters).  Entry point:
``python -m gcpnet_torch.train``."""

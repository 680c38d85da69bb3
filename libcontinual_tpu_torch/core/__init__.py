"""Core: state, metrics, optimizers, the Method protocol and the trainer."""

"""The check's plain reference: device mode's DLRM in plain PyTorch."""

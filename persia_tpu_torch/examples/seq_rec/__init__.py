"""The long-history sequence recommendation example: ``train`` (the
in-process trainer, PS in the same process)."""

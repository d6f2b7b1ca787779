"""The Criteo job: ``criteo_data``, ``send_data`` (the data-loader role)
and ``train`` (the nn-worker role, or a trainer with its PS in process)."""

"""The adult-income job: ``data_generator``, ``data_loader`` (the
data-loader role) and ``nn_worker`` (the nn-worker role)."""

"""The service tier (``persia_tpu/service/``): the coordinator, the
embedding PS and worker services with their RPC clients, and
:class:`~persia_tpu_torch.service.helper.ServiceCtx`, which runs them as
processes of their own. Run a role with ``python -m
persia_tpu_torch.service.<role>``."""

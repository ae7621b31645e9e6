"""The LM stack of the port (``src/repro/models`` is the reference):
``transformer.LM`` and ``encdec.EncDec`` as ``nn.Module``s, their
building blocks in ``layers``, ``moe`` and ``ssm``, and
``convert.from_reference_params`` to carry the reference's weights."""

"""The paper's figures on the port: one module per figure, each ``run(device)``
returning a dict of its numbers beside the paper's (``python -m
repro_torch.figures``)."""

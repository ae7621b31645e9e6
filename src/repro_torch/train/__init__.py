"""Training of the LM stack (mirrors ``repro.train``): AdamW with
global-norm clipping and a cosine schedule (``optimizer``) and the
train-step builder with microbatch accumulation (``step``)."""

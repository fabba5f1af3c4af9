"""Model zoo of the port: the LM transformers (dense, MoE, MLA).

``layers`` holds the configs and the building blocks as functions over
named parameter sets; ``transformer`` the LM as an ``nn.Module`` with its
training forward, loss value, prefill and KV-cache decode.  The GNNs and
DLRM follow with the rest of the ML stack (ROADMAP Queue 1, item 12c).
"""

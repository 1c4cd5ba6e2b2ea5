"""``libsrcnn_tpu_torch.pipeline.run_pass`` on u8 clips ``[N, H, W, 3]``
already on the card: one batched pass per request, returning the u8
output and conv map on the card.  The request is done when a CUDA event
recorded after the call has passed."""

#: whether ``call`` returns a conv map beside the output
CONV_MAP = True


def make(traffic, program_config, params, device):
    from libsrcnn_tpu_torch import pipeline

    scale = float(traffic["scale"])
    return lambda x: pipeline.run_pass(x, params, scale, program_config)

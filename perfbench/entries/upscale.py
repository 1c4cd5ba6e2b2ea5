"""``libsrcnn_tpu_torch.api.upscale`` on one host u8 still ``[H, W, 3]``,
called as a photo user calls it: it returns the output as a numpy array,
and no conv map."""

#: whether ``call`` returns a conv map beside the output
CONV_MAP = False


def make(traffic, program_config, params, device):
    from libsrcnn_tpu_torch import api

    scale = float(traffic["scale"])
    return lambda x: (api.upscale(x, scale, program_config, params=params,
                                  device=device), None)

"""The program's own quantized 9-1-5 pack, for a control that runs the
program's ``int8`` tier in its place (never for the reference)."""


def load(config, seed, device):
    from libsrcnn_tpu_torch.models import srcnn_int8

    return srcnn_int8.load_params(device)

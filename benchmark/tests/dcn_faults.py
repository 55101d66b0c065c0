"""A fault planted under the timed path of the ResNet-101-DCN cell: every
deformable conv drops its offsets (samples the plain 3x3 grid, the mask
kept), whichever path runs it, the kernel on the card or the composed
version elsewhere."""


def detect_dcn_no_offsets(det):
    from rtm3d_tpu_torch.nn import dcn

    def zeroed(om):
        om = om.clone()
        om[:, :18] = 0
        return om

    kernel, plain = dcn.modulated_deform_conv, dcn.dcn_reference
    dcn.modulated_deform_conv = lambda x, om, w: kernel(x, zeroed(om), w)
    dcn.dcn_reference = lambda x, om, w: plain(x, zeroed(om), w)
    return det

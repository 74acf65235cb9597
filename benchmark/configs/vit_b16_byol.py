"""FLOPs per image of ViT-B/16 in BYOL, from the configuration's shapes."""
from harness.flops import byol_flops, vit_forward_macs
from reference.nets import feature_dim


def flops(conf):
    return byol_flops(vit_forward_macs(conf["arch"], conf["image_size"]),
                      feature_dim(conf["arch"]), conf["heads"],
                      conf["num_classes"])

"""Host-side file codecs: camera texts, images and GT depths (PIL, the port's
EXR codec), PFM (numpy)."""

"""Host-side file codecs: camera texts, images and GT depths (the host
library's PNG and EXR decoders, ``native.py``; PIL and the port's EXR codec
for what they do not take), PFM (numpy)."""

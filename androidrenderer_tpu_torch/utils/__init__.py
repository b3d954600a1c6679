"""Utilities: image IO and SSIM, and the bit streams of the KTX2 codecs."""

"""Finetuning: the VCR and TVQA task heads (``models``) and their train
step, losses and predictions (``train``)."""

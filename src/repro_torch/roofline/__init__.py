from repro_torch.roofline.analysis import H100, HW, RooflineTerms, derive_terms

"""The image front-end: the XFeat CNN, detect_and_compute and the feature
extractor."""

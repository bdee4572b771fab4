"""Dataset converters: Pascal VOC / SBD and Cityscapes to COCO-style json."""

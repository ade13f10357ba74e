"""CNN helpers (`models.cnn`) and the dense LM (`layers`, `attention`,
`transformer`, `model`): counterparts of `repro.models`."""

"""Models of the port: the JAX package's CNN bench family (ResNet, VGG,
Inception-v3, SmallCNN, MnistCNN) on the shared flax-semantics layers of
:mod:`.layers`, and the transformer LM."""

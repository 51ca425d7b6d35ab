"""The paper's own ML workload: a surrogate model for the JAG ICF simulator
(Sec. 3.1/3.2 of the Merlin paper; cf. arXiv:1912.08113 "transfer-learned
surrogates").  Here: a compact decoder-style transformer regressor over
tokenized (input-params, observables) pairs used by the optimization-loop
and ensemble examples.  Small enough to train for real on CPU."""
from repro_torch.configs.base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="jag-surrogate",
        family="dense",
        n_layers=4,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        d_ff=1024,
        vocab_size=4096,
        superblock=(LayerSpec(kind="attn", mlp="glu"),),
        n_repeat=4,
        microbatch=1,
    )

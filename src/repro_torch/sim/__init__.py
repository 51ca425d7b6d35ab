from repro_torch.sim.jag import jag_simulate, JAG_BOUNDS, jag_sample_inputs  # noqa
from repro_torch.sim.epidemic import seir_simulate, EPI_BOUNDS  # noqa
from repro_torch.sim.nullsim import null_simulate, sleep_step  # noqa

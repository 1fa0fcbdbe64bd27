"""The port's hybrid SSM stack on a mesh against the reference on the
CPU, in float32 at smoke width: jamba's ``loss_fn`` and gradients at a
2x2 mesh, where its MoE layers run ``moe_ep`` and its Mamba-2 layers
are placement only (``wsc``).  Apart from ``test_torch_mesh_model.py``
because the reference's jitted jamba takes the longest to compile.

The reference runs in a background subprocess with 8 host devices
(``_torch_mesh.RefJobs``); the weights are its own (``PRNGKey(0)``),
the batch comes from a numpy seed.  Tolerances: loss, CE and aux within
rtol 1e-5; gradient leaves by relative L2 within 5e-4, the limit
``tests/test_torch_grads_ssm.py`` sets for jamba from the reference's
own spread under half-ulp noise (measured 1.7e-4 at 2x2).
"""

import pytest
import torch

from _torch_mesh import REF_GRADS, RefJobs, check_model_at_mesh, model_batches

torch.set_num_threads(1)

JAMBA = "jamba-1.5-large-398b"
JAMBA_REL_L2 = 5e-4


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    r = RefJobs(tmp_path_factory.mktemp("mesh_ssm_ref"), model_batches((JAMBA,)),
                {"grads": f"ARCHS = {(JAMBA,)!r}\n" + REF_GRADS}, {})
    yield r
    r.close()


def test_jamba_at_mesh_2x2_matches_reference(ref):
    check_model_at_mesh(ref, JAMBA, JAMBA_REL_L2)

"""One torch intra-op thread for the length of a test module, for the port's
test files of many small CPU tensor ops: beside the other test workers,
torch's default pool costs them more than it gives (the f32 flash walk of
test_torch_flash_fwd_f32_tiles.py's pieces0 on an 8-core CPU: 1.6 s alone
on 8 threads, 0.4 s on one, 18.5 s in a 4-worker run on 8 threads). A
module imports the fixture by name, which makes it autouse there."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

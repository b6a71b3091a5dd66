"""The port's t-SNE (``utils/tsne.py``) and ``tools.tsne_eval`` against
scikit-learn, which the JAX tool runs (``tools/tsne_eval.py:56-61``).

* Against the exact method: from one starting embedding (the port's PCA
  init passed to both as ``init``), ``TSNE(method="exact")`` and the port
  on a seeded 60 x 32 set agree within 1e-5 relative to the largest
  coordinate, and their KL divergences within 1e-5 relative; both keep
  scikit-learn's dtypes step by step, so on the CPU they come out
  bit-equal here, and the bound leaves room only for summation order.  The
  port's PCA init agrees with scikit-learn's ``init="pca"`` within 1e-5 of
  its scale (another SVD routine: ~1e-6 measured); t-SNE amplifies a
  difference that small to O(1) in the coordinates, so runs from their own
  inits are held by the next two checks.
* Against the JAX tool's output: on seeded 300 x 512 clusters its call
  (Barnes-Hut, the defaults) run here, on the demo run's 20 projected
  embeddings its committed coordinates: KL(P || Q) of the exact P
  (scikit-learn's own functions) at most 1.02 x the tool's, and
  ``trustworthiness(n_neighbors=5)`` at least the tool's - 0.02.  (A fresh
  Barnes-Hut run of this scikit-learn on the 20 demo embeddings finds a
  deeper local minimum, KL 0.0273, than the exact method, 0.0328 for
  scikit-learn's and 0.0326 for the port's: the objective is not convex,
  and at N = 20 the two gradients walk to different minima.)
* ``tsne_eval`` over the demo run on the CPU writes ``tsne_coords.csv``
  whose header and label columns equal the committed
  ``outputs/demo/run/results/tsne/tsne_coords.csv`` byte for byte, its
  ``x``, ``y`` printed as the JAX tool prints float32 values.
"""

import os

import numpy as np
import pytest
import torch

from mmgclip_tpu_torch import encode_images
from mmgclip_tpu_torch.tools import tsne_eval
from mmgclip_tpu_torch.utils.tsne import joint_probabilities, optimize, pca_init, tsne
from torch_demo import DEMO_RUN, encode_overrides, port_demo_run

pytest.importorskip("sklearn.manifold")
from sklearn.decomposition import PCA  # noqa: E402
from sklearn.manifold import TSNE, trustworthiness  # noqa: E402
from sklearn.manifold import _t_sne  # noqa: E402
from sklearn.metrics.pairwise import pairwise_distances  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The t-SNE is 1,000 iterations of small ops: with one thread per test
    worker it does not slow down when every worker's thread pool contends
    for the cores (scikit-learn's OpenMP pool too)."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


def clusters(n, dim, k, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, dim)) * 4
    return (centers[rng.integers(0, k, n)] + rng.normal(size=(n, dim))).astype(np.float32)


def exact_kl(x, embedding, perplexity):
    """KL(P || Q) with scikit-learn's exact P and objective."""
    p = _t_sne._joint_probabilities(pairwise_distances(x, squared=True), perplexity, 0)
    return _t_sne._kl_divergence(embedding.astype(np.float32).ravel(), p, 1, len(x), 2)[0]


def tool_perplexity(n, perplexity=30.0):
    return min(perplexity, max(2.0, (n - 1) / 3))


def test_matches_the_exact_method_from_one_init():
    x = clusters(60, 32, 3, seed=0)
    xt = torch.from_numpy(x)
    init = pca_init(xt)
    ref = TSNE(n_components=2, perplexity=10.0, init=init.numpy(), method="exact",
               random_state=0).fit(x)
    ours = optimize(joint_probabilities(xt, 10.0), init)
    assert ours.n_iter == ref.n_iter_
    scale = np.abs(ref.embedding_).max()
    assert np.abs(ours.embedding - ref.embedding_).max() <= TOL * scale
    assert abs(ours.kl_divergence - ref.kl_divergence_) <= TOL * abs(ref.kl_divergence_)


def test_pca_init_matches_sklearn():
    x = clusters(60, 32, 3, seed=1)
    want = PCA(n_components=2, random_state=np.random.RandomState(0)).fit_transform(x)
    want = want.astype(np.float32) / np.std(want[:, 0].astype(np.float32)) * 1e-4
    got = pca_init(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def assert_as_good_as_barnes_hut(x, seed, perplexity):
    bh = TSNE(n_components=2, perplexity=perplexity, random_state=seed, init="pca").fit_transform(x)
    ours = tsne(x, perplexity=perplexity).embedding
    kl_bh, kl_ours = exact_kl(x, bh, perplexity), exact_kl(x, ours, perplexity)
    trust_bh = trustworthiness(x, bh, n_neighbors=5)
    trust_ours = trustworthiness(x, ours, n_neighbors=5)
    assert kl_ours <= 1.02 * kl_bh, (kl_ours, kl_bh)
    assert trust_ours >= trust_bh - 0.02, (trust_ours, trust_bh)


def test_as_good_as_barnes_hut_on_clusters():
    x = clusters(300, 512, 6, seed=2)
    assert_as_good_as_barnes_hut(x, seed=42, perplexity=tool_perplexity(len(x)))


@pytest.fixture(scope="module")
def demo_tsne(tmp_path_factory):
    demo = port_demo_run(str(tmp_path_factory.mktemp("tsne_demo")))
    assert encode_images.main(encode_overrides(demo["cfg"], os.path.join(demo["root"], "encode"))) == 0
    out = tsne_eval.main(["--experiment_path", demo["run"], "--device", "cpu"])
    return demo, out


def committed_coords():
    with open(os.path.join(DEMO_RUN, "results", "tsne", "tsne_coords.csv")) as fh:
        rows = [line.split(",") for line in fh.read().splitlines()[1:]]
    return np.array([[float(r[0]), float(r[1])] for r in rows], np.float32)


def test_as_good_as_the_jax_tool_output_on_the_demo_embeddings(demo_tsne):
    """The committed coordinates are the JAX tool's own Barnes-Hut output for
    these 20 embeddings (the port's projection of them equals the JAX
    engine's within 1e-5, ``test_torch_done_check.py``)."""
    _demo, out = demo_tsne
    x, ours, theirs = out["embeddings"], out["coords"], committed_coords()
    assert x.shape == (20, 512)
    perplexity = tool_perplexity(len(x))
    assert exact_kl(x, ours, perplexity) <= 1.02 * exact_kl(x, theirs, perplexity)
    assert (trustworthiness(x, ours, n_neighbors=5)
            >= trustworthiness(x, theirs, n_neighbors=5) - 0.02)


def test_tsne_coords_csv_matches_the_demo_run(demo_tsne):
    _demo, out = demo_tsne
    with open(out["csv"]) as fh:
        ours = fh.read().splitlines()
    with open(os.path.join(DEMO_RUN, "results", "tsne", "tsne_coords.csv")) as fh:
        theirs = fh.read().splitlines()
    assert ours[0] == theirs[0] and len(ours) == len(theirs) == 21
    assert [line.split(",", 2)[2] for line in ours[1:]] == [line.split(",", 2)[2] for line in theirs[1:]]
    for line, (x, y) in zip(ours[1:], out["coords"]):
        assert line.split(",")[:2] == [f"{float(x)}", f"{float(y)}"]
        assert np.float32(float(line.split(",")[0])) == x


def test_tsne_eval_raises_without_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsne_eval.main(["--experiment_path", DEMO_RUN])

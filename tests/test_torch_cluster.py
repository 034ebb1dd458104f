"""The port's cluster control plane against the JAX package's.

Mirrors ``tests/test_cluster.py``'s generation, lease, membership-fence,
checkpoint-fence, coordinator, in-process coordinated-rewind, relaunch
hygiene, collective-deadline and chaos-site cases on
``apex_tpu_torch.cluster`` (torch leaves in the checkpoints, the JAX
package's event schema checker on the port's event stream), then holds the two packages against each other on one
cluster directory: a directory bumped and leased by one package is
fenced correctly by the other's membership, both ways; one coordinator
of each package in one round resolves to the same decision; heartbeat
files the JAX package writes are read and collected by the port. Also
the port of ``tests/test_ckpt.py::test_elastic_run_shrinks_then_succeeds``.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from apex_tpu import cluster as jcluster
from apex_tpu.trace import straggler as _jstraggler
from apex_tpu_torch import ckpt, cluster, guard, parallel
from apex_tpu_torch.ckpt import format as _format
from apex_tpu_torch.trace import straggler as _straggler

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

from scripts.check_metrics_schema import check_cluster_lines  # noqa: E402


def _collect():
    events = []
    return events, events.append


def _member(d, rank, sink=None):
    m = cluster.ClusterMembership(d, rank=rank, event_sink=sink)
    m.join()
    return m


class _FakeStepTrace:
    def __init__(self, step, dur_ms):
        self.step = step
        self.spans = []
        self.dur_ms = dur_ms


def _beat(directory, rank, steps, dur_ms, generation=None):
    """Heartbeat lines written by the JAX package's writer (the files the
    port's helpers read and collect)."""
    w = _jstraggler.HeartbeatWriter(directory, rank=rank,
                                    generation=generation)
    for s in steps:
        w.on_step(_FakeStepTrace(s, dur_ms))
    return w


class TestGeneration:
    def test_fresh_directory_is_generation_zero(self, tmp_path):
        d = str(tmp_path)
        assert cluster.read_generation(d) == 0
        assert cluster.read_generation_record(d) == {"generation": 0}

    def test_bump_is_monotone_and_recorded(self, tmp_path):
        d = str(tmp_path)
        assert cluster.bump_generation(d, rank=3, reason="test") == 1
        rec = cluster.read_generation_record(d)
        assert rec["generation"] == 1
        assert rec["prev_generation"] == 0
        assert rec["committed_by_rank"] == 3
        assert rec["reason"] == "test"
        assert cluster.bump_generation(d) == 2
        assert cluster.read_generation(d) == 2

    def test_bump_expect_cas_refuses_the_lost_race(self, tmp_path):
        d = str(tmp_path)
        cluster.bump_generation(d)                      # now at 1
        with pytest.raises(cluster.StaleGenerationError) as ei:
            cluster.bump_generation(d, expect=0)        # raced & lost
        assert ei.value.generation == 0
        assert ei.value.current == 1
        # the losing racer did NOT stack an epoch
        assert cluster.read_generation(d) == 1
        # a matching expect commits
        assert cluster.bump_generation(d, expect=1) == 2

    def test_epoch_filename_is_authoritative_over_torn_content(
            self, tmp_path):
        d = str(tmp_path)
        # a stray non-epoch file is ignored entirely
        with open(os.path.join(d, "generation.notanepoch.json"),
                  "w") as f:
            f.write("{torn")
        assert cluster.read_generation(d) == 0
        # an epoch FILE with torn/mismatched content still commits its
        # epoch — the filename is the commit (the no-hardlink
        # fallback's brief torn window), content is only forensics
        with open(cluster.generation_path(d, 2), "w") as f:
            f.write("{torn")
        assert cluster.read_generation(d) == 2
        assert cluster.read_generation_record(d) == {"generation": 2}

    def test_stalled_writer_cannot_roll_the_epoch_backwards(
            self, tmp_path, monkeypatch):
        """The rollback race the exclusive-create publish closes: a
        writer that read generation 0, passed its expect pre-check,
        then stalled while the cluster moved to 2 must be REFUSED at
        publish time — not land epoch 1 over the committed 2."""
        from apex_tpu_torch.cluster import membership as _membership
        d = str(tmp_path)
        cluster.bump_generation(d)                      # 0 -> 1
        cluster.bump_generation(d)                      # 1 -> 2
        # replay the stalled writer: its read happened BEFORE the two
        # bumps, so both its pre-check and its error-path re-read see
        # the stale 0 — only the publish-side exclusive create (the
        # target epoch-1 file already exists) can refuse it
        monkeypatch.setattr(_membership, "read_generation",
                            lambda _d: 0)
        with pytest.raises(cluster.StaleGenerationError):
            _membership.bump_generation(d, expect=0)
        monkeypatch.undo()
        assert cluster.read_generation(d) == 2


class TestLease:
    def test_acquire_renew_release_roundtrip(self, tmp_path):
        d = str(tmp_path)
        lw = cluster.LeaseWriter(d, rank=2, ttl_s=30.0)
        assert lw.acquire(0)
        t0 = time.time()
        leases = cluster.read_leases(d)
        assert set(leases) == {2}
        rec = leases[2]
        assert rec["generation"] == 0 and rec["rank"] == 2
        assert rec["pid"] == os.getpid()
        assert abs(rec["expires_at"] - (t0 + 30.0)) < 5.0
        assert isinstance(rec["mac"], str) and len(rec["mac"]) == 64
        assert lw.renew()
        assert cluster.read_leases(d)[2]["n_renewals"] == 1
        lw.release()
        assert cluster.read_leases(d) == {}

    def test_torn_lease_file_is_skipped(self, tmp_path):
        d = str(tmp_path)
        cluster.LeaseWriter(d, rank=0).acquire(0)
        with open(cluster.lease_path(d, 1), "w") as f:
            f.write('{"rank": 1, "gener')       # torn tail
        assert set(cluster.read_leases(d)) == {0}

    def test_expire_now_is_the_lease_expire_chaos_site(self, tmp_path):
        d = str(tmp_path)
        m = cluster.ClusterMembership(d, rank=0, ttl_s=60.0)
        m.join()
        assert m.alive_ranks() == [0]
        assert m.expired_ranks() == []
        assert m.lease.expire_now()
        assert m.alive_ranks() == []
        assert m.expired_ranks() == [0]

    def test_alive_ranks_excludes_other_generations(self, tmp_path):
        d = str(tmp_path)
        m0 = cluster.ClusterMembership(d, rank=0)
        m0.join()
        stale = cluster.LeaseWriter(d, rank=1, ttl_s=60.0)
        stale.acquire(0)
        assert m0.alive_ranks() == [0, 1]
        m0.bump("shrink")           # commits generation 1, re-leases
        # rank 1's unexpired lease still claims generation 0: not alive
        assert m0.alive_ranks() == [0]

    def test_gc_stale_leases(self, tmp_path):
        d = str(tmp_path)
        old = cluster.LeaseWriter(d, rank=1)
        old.acquire(0)
        cluster.bump_generation(d)
        cur = cluster.LeaseWriter(d, rank=0)
        cur.acquire(1)
        removed = cluster.gc_stale_leases(d, 1)
        assert removed == [cluster.lease_path(d, 1)]
        assert set(cluster.read_leases(d)) == {0}

    def test_foreign_lease_is_not_a_member_and_gc_eligible(self,
                                                           tmp_path):
        """A stray/foreign lease file (valid JSON, no valid MAC) must
        not read as a phantom member — it would stall every recovery
        barrier for the full timeout waiting on its intent — and gc
        may remove it even when its claimed generation is current."""
        d = str(tmp_path)
        m = cluster.ClusterMembership(d, rank=0, ttl_s=60.0)
        m.join()
        with open(cluster.lease_path(d, 5), "w") as f:
            json.dump({"rank": 5, "generation": 0,
                       "expires_at": time.time() + 1e6,
                       "mac": "f" * 64}, f)
        # raw read still sees it; the verified membership view doesn't
        assert 5 in cluster.read_leases(d)
        assert 5 not in m.leases()
        assert m.alive_ranks() == [0]
        removed = cluster.gc_stale_leases(d, 0,
                                          token=m.lease.token)
        assert removed == [cluster.lease_path(d, 5)]
        assert 0 in cluster.read_leases(d)


class TestMembershipFence:
    def test_join_check_pass_at_current_generation(self, tmp_path):
        events, sink = _collect()
        m = cluster.ClusterMembership(str(tmp_path), rank=0,
                                      event_sink=sink)
        assert m.join() == 0
        assert m.check("commit") == 0
        assert [e["kind"] for e in events] == ["cluster_lease"]
        assert events[0]["action"] == "acquire"

    def test_zombie_check_refuses_and_emits_fence_event(self, tmp_path):
        d = str(tmp_path)
        zombie_events, zsink = _collect()
        zombie = cluster.ClusterMembership(d, rank=1, event_sink=zsink)
        zombie.join()
        other = cluster.ClusterMembership(d, rank=0)
        other.join()
        other.bump("recovery")      # the world moves on
        with pytest.raises(cluster.StaleGenerationError) as ei:
            zombie.check("commit", path="/ck/step_8", step=8)
        assert "zombie" in str(ei.value)
        fences = [e for e in zombie_events
                  if e["kind"] == "cluster_fence"]
        assert len(fences) == 1
        ev = fences[0]
        assert ev["action"] == "refused_commit"
        assert ev["generation"] == 0 and ev["current_generation"] == 1
        assert ev["path"] == "/ck/step_8" and ev["step"] == 8
        # write and delete refusals carry their own action names
        with pytest.raises(cluster.StaleGenerationError):
            zombie.check("write")
        with pytest.raises(cluster.StaleGenerationError):
            zombie.check("delete")
        acts = [e["action"] for e in zombie_events
                if e["kind"] == "cluster_fence"]
        assert acts == ["refused_commit", "refused_write",
                        "refused_delete"]

    def test_bump_emits_and_rejoin_adopts(self, tmp_path):
        d = str(tmp_path)
        events, sink = _collect()
        m = cluster.ClusterMembership(d, rank=0, event_sink=sink)
        m.join()
        assert m.bump("coordinated_rewind") == 1
        bumps = [e for e in events if e["kind"] == "cluster_generation"]
        assert bumps[0]["action"] == "bump"
        assert bumps[0]["generation"] == 1
        assert bumps[0]["prev_generation"] == 0
        follower = cluster.ClusterMembership(d, rank=1)
        follower.join()
        assert follower.generation == 1
        assert follower.check("commit") == 1

    def test_split_brain_claim_is_refused_everywhere(self, tmp_path):
        d = str(tmp_path)
        events, sink = _collect()
        m = cluster.ClusterMembership(d, rank=1, event_sink=sink)
        m.join()
        m.claim_generation(5)       # an epoch the cluster never agreed
        # the fence refuses ANY mismatch — a future claim is
        # split-brain, not seniority
        with pytest.raises(cluster.StaleGenerationError) as ei:
            m.check("commit")
        assert "split-brain" in str(ei.value)
        assert any(e["kind"] == "cluster_fence" and e["generation"] == 5
                   and e["current_generation"] == 0 for e in events)
        # and the CAS bump refuses to commit the claim
        with pytest.raises(cluster.StaleGenerationError):
            m.bump("split")         # expect=5, disk at 0
        assert cluster.read_generation(d) == 0

    def test_gc_stale_cleans_leases_heartbeats_intents(self, tmp_path):
        d = str(tmp_path)
        hb_dir = str(tmp_path / "hb")
        old = cluster.LeaseWriter(d, rank=7)
        old.acquire(0)
        _beat(hb_dir, 7, [3], 10.0, generation=0)
        # a resolved round's intent files are inert once the epoch
        # moved — but must not accumulate under the per-step
        # pending() listdir forever
        stale_member = cluster.ClusterMembership(d, rank=7)
        stale_member.join()
        stale_intent = cluster.RecoveryCoordinator(
            stale_member).propose(action="rewind", step=3, good_step=2)
        events, sink = _collect()
        m = cluster.ClusterMembership(d, rank=0, event_sink=sink)
        m.join()
        m.bump("restart")
        removed = m.gc_stale(heartbeat_dir=hb_dir)
        assert cluster.lease_path(d, 7) in removed
        assert _straggler.heartbeat_path(hb_dir, 7) in removed
        assert stale_intent in removed
        assert not os.path.exists(stale_intent)
        assert any(e["kind"] == "cluster_lease" and e["action"] == "gc"
                   for e in events)


class TestCkptFence:
    def _tree(self, v=1.0):
        return {"w": torch.full((8,), v)}

    def test_fenced_save_records_generation(self, tmp_path):
        d, root = str(tmp_path / "c"), str(tmp_path / "ck")
        m = cluster.ClusterMembership(d, rank=0)
        m.join()
        mgr = ckpt.CheckpointManager(root, fence=m, rank=0,
                                     process_count=1)
        mgr.save(1, self._tree(), block=True)
        mgr.wait()
        manifest = ckpt.read_manifest(ckpt.latest_checkpoint(root))
        assert manifest["generation"] == 0

    def test_zombie_save_is_refused_before_any_byte_lands(self,
                                                          tmp_path):
        d, root = str(tmp_path / "c"), str(tmp_path / "ck")
        events, sink = _collect()
        zombie = cluster.ClusterMembership(d, rank=0, event_sink=sink)
        zombie.join()
        mgr = ckpt.CheckpointManager(root, fence=zombie, rank=0,
                                     process_count=1)
        mgr.save(1, self._tree(), block=True)
        mgr.wait()
        other = cluster.ClusterMembership(d, rank=1)
        other.join()
        other.bump("relaunch")
        mgr.save(2, self._tree(2.0), block=True)
        with pytest.raises(cluster.StaleGenerationError):
            mgr.wait()
        # nothing of step 2 landed: no dir, latest still step 1
        assert not os.path.exists(ckpt.step_dir(root, 2))
        assert ckpt.latest_checkpoint(root) == ckpt.step_dir(root, 1)
        assert any(e["kind"] == "cluster_fence"
                   and e["action"] == "refused_write" for e in events)

    def test_zombie_gc_is_refused(self, tmp_path):
        d, root = str(tmp_path / "c"), str(tmp_path / "ck")
        fresh = cluster.ClusterMembership(d, rank=0)
        fresh.join()
        mgr = ckpt.CheckpointManager(root, fence=fresh, rank=0,
                                     process_count=1, keep=0)
        for s in (1, 2, 3):
            mgr.save(s, self._tree(float(s)), block=True)
        mgr.wait()
        zombie = cluster.ClusterMembership(d, rank=1)
        zombie.join()
        fresh.bump("relaunch")
        with pytest.raises(cluster.StaleGenerationError):
            ckpt.gc_checkpoints(root, keep=1, fence=zombie)
        assert len(ckpt.committed_steps(root)) == 3
        # the CURRENT generation's holder may gc
        removed = ckpt.gc_checkpoints(root, keep=1, fence=fresh)
        assert len(removed) == 2
        assert ckpt.committed_steps(root) == [3]

    def test_commit_manifest_explicit_generation(self, tmp_path):
        d = str(tmp_path / "step_00000001")
        _format.write_process_file(d, 0, [("['w']",
                                           np.zeros(4, np.float32))])
        _format.commit_manifest(d, step=1, process_count=1,
                                generation=7)
        assert _format.read_manifest(d)["generation"] == 7


class TestCoordinator:
    def test_propose_pending_verify_roundtrip(self, tmp_path):
        d = str(tmp_path)
        m0, m1 = _member(d, 0), _member(d, 1)
        c0 = cluster.RecoveryCoordinator(m0, barrier_timeout_s=1.0)
        c1 = cluster.RecoveryCoordinator(m1, barrier_timeout_s=1.0)
        assert not c0.peer_requested()
        c1.propose(action="rewind", step=8, good_step=6)
        assert c0.peer_requested()
        pend = c0.pending()
        assert set(pend) == {1}
        assert pend[1]["good_step"] == 6 and pend[1]["action"] == \
            "rewind"
        assert c0.last_refused == ()

    def test_tampered_intent_is_refused(self, tmp_path):
        d = str(tmp_path)
        events, sink = _collect()
        m0 = _member(d, 0, sink)
        m1 = _member(d, 1)
        c0 = cluster.RecoveryCoordinator(m0, barrier_timeout_s=1.0)
        c1 = cluster.RecoveryCoordinator(m1, barrier_timeout_s=1.0)
        path = c1.propose(action="rewind", step=8, good_step=6)
        rec = json.load(open(path))
        rec["good_step"] = 0            # tamper without re-MACing
        with open(path, "w") as f:
            json.dump(rec, f)
        assert c0.pending() == {}
        assert c0.last_refused == (1,)
        refusals = [e for e in events if e["kind"] == "cluster_fence"]
        assert refusals and refusals[0]["action"] == "refused_intent"
        assert "bad signature" in refusals[0]["reason"]

    def test_split_brain_intent_is_refused(self, tmp_path):
        d = str(tmp_path)
        events, sink = _collect()
        m0 = _member(d, 0, sink)
        m1 = _member(d, 1)
        m1.claim_generation(3)      # the split_brain chaos site
        c0 = cluster.RecoveryCoordinator(m0, barrier_timeout_s=1.0)
        c1 = cluster.RecoveryCoordinator(m1, barrier_timeout_s=1.0)
        c1.propose(action="rewind", step=8, good_step=6)
        # the claimed epoch's intent lands under its OWN prefix — the
        # verifier at the committed generation never even counts it,
        # and a same-prefix forgery is refused by generation check
        assert c0.pending() == {}
        assert not c0.peer_requested()
        # forge the filename down to the committed generation: the
        # payload still claims generation 3 — refused, with evidence
        src = cluster.intent_path(d, 3, 1)
        dst = cluster.intent_path(d, 0, 1)
        os.replace(src, dst)
        assert c0.pending() == {}
        assert c0.last_refused == (1,)
        refusals = [e for e in events if e["kind"] == "cluster_fence"]
        assert refusals[-1]["action"] == "refused_intent"
        assert "claims generation 3" in refusals[-1]["reason"]

    def test_resolve_oldest_good_step_wins_single_bump(self, tmp_path):
        d = str(tmp_path)
        events, sink = _collect()
        m0, m1 = _member(d, 0, sink), _member(d, 1, sink)
        c0 = cluster.RecoveryCoordinator(m0, barrier_timeout_s=5.0)
        c1 = cluster.RecoveryCoordinator(m1, barrier_timeout_s=5.0)
        c0.propose(action="rewind", step=9, good_step=8)
        c1.propose(action="rewind", step=9, good_step=6)
        d0 = c0.resolve(expect_ranks=[0, 1])    # leader: bumps
        d1 = c1.resolve(expect_ranks=[0, 1])    # follower: observes
        for dec in (d0, d1):
            assert dec.action == "rewind"
            assert dec.target_step == 6         # oldest good wins
            assert dec.ranks == (0, 1) and dec.leader == 0
            assert dec.generation == 0 and dec.new_generation == 1
        assert cluster.read_generation(d) == 1
        bumps = [e for e in events
                 if e["kind"] == "cluster_generation"
                 and e["action"] == "bump"]
        assert len(bumps) == 1, "generation must bump exactly once"
        assert m0.generation == 1 and m1.generation == 1

    def test_escalate_dominates_and_none_good_forces_it(self,
                                                        tmp_path):
        d = str(tmp_path)
        m0, m1 = _member(d, 0), _member(d, 1)
        c0 = cluster.RecoveryCoordinator(m0, barrier_timeout_s=5.0)
        c1 = cluster.RecoveryCoordinator(m1, barrier_timeout_s=5.0)
        c0.propose(action="rewind", step=9, good_step=8)
        c1.propose(action="escalate", step=9, good_step=6)
        dec = c0.resolve(expect_ranks=[0, 1], bump=False)
        assert dec.action == "escalate" and dec.target_step is None

        d2 = str(tmp_path / "none")
        m0b, m1b = _member(d2, 0), _member(d2, 1)
        c0b = cluster.RecoveryCoordinator(m0b, barrier_timeout_s=5.0)
        c1b = cluster.RecoveryCoordinator(m1b, barrier_timeout_s=5.0)
        c0b.propose(action="rewind", step=9, good_step=8)
        c1b.propose(action="rewind", step=9, good_step=None)
        dec = c0b.resolve(expect_ranks=[0, 1], bump=False)
        assert dec.action == "escalate", \
            "a rank with NO restorable checkpoint forces escalation"

    def test_barrier_timeout_proceeds_with_present_intents(self,
                                                           tmp_path):
        d = str(tmp_path)
        events, sink = _collect()
        m0 = _member(d, 0, sink)
        c0 = cluster.RecoveryCoordinator(m0, barrier_timeout_s=0.3)
        c0.propose(action="rewind", step=9, good_step=4)
        t0 = time.monotonic()
        dec = c0.resolve(expect_ranks=[0, 1], bump=False)
        assert time.monotonic() - t0 < 10.0
        assert dec.action == "rewind" and dec.target_step == 4
        assert dec.ranks == (0,)
        timeouts = [e for e in events
                    if e.get("action") == "barrier_timeout"]
        assert timeouts and timeouts[0]["missing"] == [1]

    def test_zero_intents_raises_coordination_error(self, tmp_path):
        m0 = _member(str(tmp_path), 0)
        c0 = cluster.RecoveryCoordinator(m0, barrier_timeout_s=0.2)
        with pytest.raises(cluster.CoordinationError):
            c0.resolve(expect_ranks=[1])

    def test_invalid_action_refused_at_the_door(self, tmp_path):
        m0 = _member(str(tmp_path), 0)
        c0 = cluster.RecoveryCoordinator(m0)
        with pytest.raises(ValueError):
            c0.propose(action="reboot", step=1, good_step=0)


class TestCoordinatedRewindInProcess:
    """The deterministic-resolution property, driven through real
    GuardPolicy/CheckpointManager instances for two logical ranks over
    one shared cluster directory — the multi-PROCESS acceptance twin is
    TestCoordinatedRewindAcceptance."""

    def test_both_ranks_land_on_the_common_target(self, tmp_path):
        d = str(tmp_path / "cluster")
        events, sink = _collect()
        members = [_member(d, r, sink) for r in (0, 1)]
        coords = [cluster.RecoveryCoordinator(m, barrier_timeout_s=10.0)
                  for m in members]
        mgrs, policies, likes = [], [], []
        for r in (0, 1):
            mgr = ckpt.CheckpointManager(
                str(tmp_path / f"ck_r{r}"), fence=members[r], rank=0,
                process_count=1, keep=0)
            # rank-local histories: rank 1's newest checkpoint captured
            # NaN params (the rank-asymmetric corruption), rank 0's is
            # healthy — so their newest GOOD steps differ (8 vs 6)
            for s in (4, 6, 8):
                bad = (r == 1 and s == 8)
                w = np.full((4,), np.nan if bad else float(s),
                            np.float32)
                mgr.save(s, {"w": torch.as_tensor(w)},
                         extra={"cursor": {"index": s}}, block=True)
                mgr.wait()
            mgrs.append(mgr)
            policies.append(guard.GuardPolicy(manager=mgr))
            likes.append({"w": torch.zeros(4)})
        assert policies[0].probe_good_step(likes[0]) == 8
        assert policies[1].probe_good_step(likes[1]) == 6

        src = _FakeCursorSource()
        # rank 1 detected the corruption; rank 0 is healthy but joins
        coords[1].propose(action="rewind", step=9,
                          good_step=policies[1].probe_good_step(
                              likes[1]))
        assert coords[0].peer_requested()
        dec0, res0 = coords[0].run_round(policies[0], 9, likes[0], src,
                                         expect_ranks=[0, 1])
        dec1, res1 = coords[1].run_round(policies[1], 9, likes[1], src,
                                         expect_ranks=[0, 1])
        for dec in (dec0, dec1):
            assert dec.action == "rewind" and dec.target_step == 6
            assert dec.new_generation == 1
        # BOTH ranks restored step 6 — rank 0 honored the cluster
        # target over its own newer good checkpoint
        for r, res in ((0, res0), (1, res1)):
            restored, manifest = res
            assert manifest["step"] == 6
            assert np.allclose(np.asarray(restored["w"]), 6.0)
        assert cluster.read_generation(d) == 1
        bumps = [e for e in events
                 if e["kind"] == "cluster_generation"
                 and e["action"] == "bump"]
        assert len(bumps) == 1
        # the whole exchange validates as a cluster event stream
        lines = [json.dumps(e) for e in events]
        assert not check_cluster_lines(lines)

    def test_unloadable_agreed_target_escalates_not_diverges(
            self, tmp_path):
        """A rank that cannot restore the AGREED target must escalate
        — rewind's fallback chain restoring an older step would put
        this rank on a different history than its peers, the exact
        split-brain the round exists to prevent."""
        d = str(tmp_path / "cluster")
        _, sink = _collect()
        members = [_member(d, r, sink) for r in (0, 1)]
        coords = [cluster.RecoveryCoordinator(m, barrier_timeout_s=10.0)
                  for m in members]
        mgrs, policies, likes = [], [], []
        for r in (0, 1):
            mgr = ckpt.CheckpointManager(
                str(tmp_path / f"ck_r{r}"), fence=members[r], rank=0,
                process_count=1, keep=0)
            # rank 1's newest (8) is NaN -> its good step is 6; rank 0
            # is all-healthy (good step 8)
            for s in (4, 6, 8):
                bad = (r == 1 and s == 8)
                w = np.full((4,), np.nan if bad else float(s),
                            np.float32)
                mgr.save(s, {"w": torch.as_tensor(w)},
                         extra={"cursor": {"index": s}}, block=True)
                mgr.wait()
            mgrs.append(mgr)
            policies.append(guard.GuardPolicy(manager=mgr))
            likes.append({"w": torch.zeros(4)})
        # truncate rank 0's copy of the agreed target (step 6) AFTER
        # it voted: the hash check rejects it at restore time and the
        # fallback chain would silently land on step 4
        tgt = _format.step_dir(str(tmp_path / "ck_r0"), 6)
        proc = os.path.join(tgt, "proc00000.npz")
        with open(proc, "r+b") as f:
            f.truncate(16)
        coords[1].propose(action="rewind", step=9,
                          good_step=policies[1].probe_good_step(
                              likes[1]))
        src = _FakeCursorSource()
        with pytest.raises(guard.GuardEscalation) as exc:
            coords[0].run_round(policies[0], 9, likes[0], src,
                                expect_ranks=[0, 1])
        assert "coordinated rewind diverged" in str(exc.value)
        assert "agreed on step 6" in str(exc.value)


class _FakeCursorSource:
    """Minimal GuardPolicy.rewind source: cursor only, no decode."""

    def __init__(self):
        self._index = 9

    def cursor_index(self):
        return self._index

    def load_state(self, state):
        self._index = int(state.get("index", 0)) if isinstance(
            state, dict) else 0

    def skip_batches(self, n):
        self._index += int(n)


class TestElasticRelaunchHygiene:
    def test_relaunch_bumps_and_cleans(self, tmp_path):
        d, hb = str(tmp_path / "c"), str(tmp_path / "hb")
        stale = cluster.LeaseWriter(d, rank=1)
        stale.acquire(0)
        _beat(hb, 1, [1, 2], 10.0, generation=0)
        events, sink = _collect()
        gen = cluster.relaunch(d, reason="elastic_restart:1",
                               heartbeat_dir=hb, event_sink=sink)
        assert gen == 1
        assert cluster.read_generation(d) == 1
        assert cluster.read_leases(d) == {}, \
            "relaunch must leave a clean lease table (incl. its own)"
        assert _straggler.read_heartbeats(hb) == {}
        assert not check_cluster_lines([json.dumps(e) for e in events])

    def test_elastic_run_fences_each_restart(self, tmp_path):
        from apex_tpu_torch.parallel.launch import elastic_run
        d, hb = str(tmp_path / "c"), str(tmp_path / "hb")
        seen, events = [], []

        def train(world, attempt):
            seen.append((world, attempt, cluster.read_generation(d)))
            if attempt == 0:
                # the failing attempt leaves the stale debris a real
                # dead rank leaves: an EXPIRED rank-0 lease and a
                # heartbeat file (rank 0 because the controller's own
                # default rank collides with it — the report must
                # still see the dead member, not overwrite its lease)
                dead = cluster.LeaseWriter(d, rank=0)
                dead.acquire(0)
                dead.expire_now()
                _beat(hb, 0, [1], 10.0, generation=0)
                raise ckpt.PreemptionError("rank died")
            assert cluster.read_leases(d) == {}
            assert _straggler.read_heartbeats(hb) == {}

        elastic_run(train, world_sizes=[8, 4], cluster_dir=d,
                    heartbeat_dir=hb, event_sink=events.append)
        assert seen == [(8, 0, 0), (4, 1, 1)], \
            "the restart must run under a freshly bumped generation"
        # the dead rank was REPORTED (lease observed expired), not
        # silently overwritten by the controller's own lease
        expires = [e for e in events
                   if e["kind"] == "cluster_lease"
                   and e["action"] == "expire"]
        assert expires and expires[0]["expired_rank"] == 0


class TestClusterChaosSites:
    def test_sites_registered_and_validated(self):
        assert guard.chaos.SITES["cluster"] == (
            "lease_expire", "zombie_resume", "split_brain")
        plan = guard.FaultPlan(seed=1).add(3, "cluster",
                                           "lease_expire")
        rt = guard.FaultPlan.from_json(plan.to_json())
        assert rt.at(3, 0, "cluster").kind == "lease_expire"
        with pytest.raises(ValueError):
            guard.FaultPlan(seed=1).add(3, "cluster", "explode")

    def test_lease_expire_site(self, tmp_path):
        d = str(tmp_path)
        m = cluster.ClusterMembership(d, rank=0, ttl_s=60.0)
        m.join()
        plan = guard.FaultPlan(seed=1).add(2, "cluster",
                                           "lease_expire")
        h = guard.ChaosHarness(plan)
        state = {"w": np.ones(2)}
        h.post_step(1, state, membership=m)
        assert m.expired_ranks() == []
        h.post_step(2, state, membership=m)
        assert m.expired_ranks() == [0]
        assert h.injected == [(2, "cluster", "lease_expire")]

    def test_split_brain_site(self, tmp_path):
        d = str(tmp_path)
        m = cluster.ClusterMembership(d, rank=1, ttl_s=60.0)
        m.join()
        plan = guard.FaultPlan(seed=1).add(2, "cluster", "split_brain",
                                           rank=1)
        h = guard.ChaosHarness(plan, rank=1)
        h.post_step(2, {"w": np.ones(2)}, membership=m)
        assert m.generation == 1           # claimed, never committed
        assert cluster.read_generation(d) == 0
        with pytest.raises(cluster.StaleGenerationError):
            m.bump("post-split")           # the CAS refuses the claim

    def test_cluster_fault_requires_membership(self, tmp_path):
        plan = guard.FaultPlan(seed=1).add(2, "cluster",
                                           "lease_expire")
        h = guard.ChaosHarness(plan)
        with pytest.raises(ValueError):
            h.post_step(2, {"w": np.ones(2)})


# --- the collective-deadline watchdog (a fake tracer: the port's Tracer is
# queue A item 11) ---------------------------------------------------------

class _FakeTracer:
    def __init__(self):
        self.probe = None

    def in_flight_collective_age(self):
        return self.probe


class _TripSpy:
    def __init__(self):
        self.reasons = []

    def trip(self, reason):
        self.reasons.append(reason)


class TestCollectiveDeadline:
    def test_slow_collective_does_not_fire(self):
        tr = _FakeTracer()
        cd = cluster.CollectiveDeadline(tr, deadline_s=10.0)
        assert cd.poll_once() is None          # nothing open
        tr.probe = ("ddp/sync_gradients", 2.0)
        assert cd.poll_once() is None          # open but young
        assert cd.fired == 0

    def test_hung_collective_fires_once_per_instance(self):
        tr = _FakeTracer()
        spy = _TripSpy()
        events, sink = _collect()
        cd = cluster.CollectiveDeadline(tr, deadline_s=5.0,
                                        escalation=spy,
                                        event_sink=sink,
                                        generation=lambda: 2)
        # the third probe element is the span's STABLE start stamp —
        # the instance identity the fire-once logic keys on (a
        # re-derived now−age would drift between polls)
        tr.probe = ("ddp/sync_gradients", 7.5, 100.0)
        ev = cd.poll_once()
        assert ev is not None
        assert ev["action"] == "collective_hang"
        assert ev["collective"] == "ddp/sync_gradients"
        assert ev["generation"] == 2
        assert spy.reasons == ["collective:ddp/sync_gradients"]
        # the SAME span instance (age grows, start fixed) never refires
        tr.probe = ("ddp/sync_gradients", 8.5, 100.0)
        assert cd.poll_once() is None
        assert cd.fired == 1
        # a NEW instance (fresh start: the old one closed) re-arms
        tr.probe = None
        assert cd.poll_once() is None
        tr.probe = ("ddp/sync_gradients", 9.0, 200.0)
        assert cd.poll_once() is not None
        assert cd.fired == 2
        assert not check_cluster_lines([json.dumps(e) for e in events])

    def test_daemon_lifecycle(self):
        tr = _FakeTracer()
        cd = cluster.CollectiveDeadline(tr, deadline_s=0.05,
                                        poll_s=0.02)
        tr.probe = ("zero/grad_scatter", 1.0)
        with cd:
            t0 = time.monotonic()
            while cd.fired == 0 and time.monotonic() - t0 < 10.0:
                time.sleep(0.02)
        assert cd.fired >= 1


# --- the two packages on one cluster directory --------------------------------

class TestInterop:
    def test_jax_bump_fences_the_port_zombie(self, tmp_path):
        d = str(tmp_path)
        events, sink = _collect()
        zombie = _member(d, 1, sink)
        jm = jcluster.ClusterMembership(d, rank=0)
        jm.join()
        assert jm.lease.token == zombie.lease.token
        jm.bump("relaunch")
        with pytest.raises(cluster.StaleGenerationError):
            zombie.check("commit", step=3)
        assert events[-1]["kind"] == "cluster_fence"
        assert events[-1]["current_generation"] == 1
        # a port member joining now adopts the JAX package's epoch
        assert _member(d, 2).check("write") == 1
        # the JAX package's lease reads as a verified, live member
        assert 0 in zombie.leases() and 0 in _member(d, 3).alive_ranks()

    def test_port_bump_fences_the_jax_zombie(self, tmp_path):
        d = str(tmp_path)
        jz = jcluster.ClusterMembership(d, rank=1)
        jz.join()
        m = _member(d, 0)
        m.bump("relaunch")
        rec = jcluster.read_generation_record(d)
        assert rec["generation"] == 1 and rec["committed_by_rank"] == 0
        with pytest.raises(jcluster.StaleGenerationError):
            jz.check("commit")
        assert set(jcluster.read_leases(d)) == {0, 1}
        assert jcluster.mac_ok(jz.lease.token,
                               jcluster.read_leases(d)[0])
        # the JAX package's gc removes the port's stale lease too
        jm = jcluster.ClusterMembership(d, rank=0)
        jm.join()
        removed = jm.gc_stale()
        assert jcluster.lease_path(d, 1) in removed

    def test_signatures_agree(self, tmp_path):
        token = cluster.cluster_token(str(tmp_path))
        assert jcluster.cluster_token(str(tmp_path)) == token
        payload = {"rank": 3, "generation": 2, "step": 7, "x": [1, 2.5]}
        assert cluster.sign_payload(token, payload) == \
            jcluster.membership.sign_payload(token, payload)

    @pytest.mark.parametrize("leader", ["port", "jax"])
    def test_mixed_round_resolves_one_decision(self, tmp_path, leader):
        d = str(tmp_path)
        events, sink = _collect()
        port_rank, jax_rank = (0, 1) if leader == "port" else (1, 0)
        pm = _member(d, port_rank, sink)
        jm = jcluster.ClusterMembership(d, rank=jax_rank)
        jm.join()
        pc = cluster.RecoveryCoordinator(pm, barrier_timeout_s=10.0)
        jc = jcluster.RecoveryCoordinator(jm, barrier_timeout_s=10.0)
        pc.propose(action="rewind", step=9, good_step=8)
        jc.propose(action="rewind", step=9, good_step=6)
        assert set(pc.pending()) == {0, 1} == set(jc.pending())
        first, second = (pc, jc) if leader == "port" else (jc, pc)
        d1 = first.resolve(expect_ranks=[0, 1])      # the leader bumps
        d2 = second.resolve(expect_ranks=[0, 1])     # the follower waits
        for dec in (d1, d2):
            assert (dec.action, dec.target_step, dec.generation,
                    dec.new_generation, tuple(dec.ranks), dec.leader) == \
                ("rewind", 6, 0, 1, (0, 1), 0)
        assert cluster.read_generation(d) == 1
        assert pm.generation == 1 and jm.generation == 1
        assert not check_cluster_lines([json.dumps(e) for e in events])

    def test_port_gc_collects_jax_heartbeats_and_intents(self, tmp_path):
        d, hb = str(tmp_path / "c"), str(tmp_path / "hb")
        _beat(hb, 4, [1, 2], 10.0, generation=0)
        _beat(hb, 5, [1], 10.0, generation=1)
        jm = jcluster.ClusterMembership(d, rank=4)
        jm.join()
        stale = jcluster.RecoveryCoordinator(jm).propose(
            action="rewind", step=2, good_step=1)
        m = _member(d, 0)
        m.bump("restart")
        assert set(_straggler.read_heartbeats(hb)) == {4, 5}
        assert set(_straggler.read_heartbeats(hb, generation=1)) == {5}
        removed = m.gc_stale(heartbeat_dir=hb)
        assert _straggler.heartbeat_path(hb, 4) in removed
        assert stale in removed
        assert set(_jstraggler.read_heartbeats(hb)) == {5}


def test_elastic_run_shrinks_then_succeeds():
    calls = []

    def train_fn(world, attempt):
        calls.append(world)
        if len(calls) == 1:
            raise ckpt.PreemptionError("stall")
        if len(calls) == 2:
            raise SystemExit(ckpt.ESCALATION_EXIT_CODE)
        return f"done@{world}"

    out = parallel.elastic_run(
        train_fn, world_sizes=parallel.shrink_schedule(8, min_world=2))
    assert out == "done@2"
    assert calls == [8, 4, 2]
    # non-escalation exits propagate — escalation never masks bugs
    with pytest.raises(SystemExit):
        parallel.elastic_run(lambda w, a: (_ for _ in ()).throw(
            SystemExit(1)), world_sizes=[8, 4])


def test_elastic_run_limits_and_backoff(monkeypatch):
    """``max_restarts`` and the smallest size end the ladder; the jittered
    backoff runs only before a relaunch."""
    from apex_tpu_torch.utils import backoff
    slept = []
    monkeypatch.setattr(backoff, "backoff_sleep",
                        lambda a, **kw: slept.append((a, kw)))

    def always(world, attempt):
        raise ckpt.PreemptionError("gone")

    once = [(0, {"base_s": 0.5, "cap_s": 60.0})]
    with pytest.raises(RuntimeError, match="max_restarts=1"):
        parallel.elastic_run(always, world_sizes=[4, 2, 1], max_restarts=1,
                             restart_backoff_s=0.5)
    assert slept == once        # before the relaunch, not before the raise
    slept.clear()
    with pytest.raises(RuntimeError, match="no capacity left"):
        parallel.elastic_run(always, world_sizes=[2, 1],
                             restart_backoff_s=0.5)
    assert slept == once
    with pytest.raises(ValueError):
        parallel.elastic_run(always, world_sizes=[])


_ZOMBIE_CHILD = """
import sys
import torch
from apex_tpu_torch import ckpt, cluster, guard

root, cluster_dir = sys.argv[1:3]
events = []
member = cluster.ClusterMembership(cluster_dir, rank=1,
                                   event_sink=events.append)
member.join()
mgr = ckpt.CheckpointManager(root, fence=member, rank=0, process_count=1,
                             keep=0)
state = {"w": torch.ones(4)}
mgr.save(1, state, block=True)
mgr.wait()
plan = guard.FaultPlan(seed=1).add(2, "cluster", "zombie_resume", rank=1)
guard.ChaosHarness(plan, rank=1).post_step(2, state, membership=member)
refused = 0
try:
    mgr.save(2, state, block=True)
    mgr.wait()
except cluster.StaleGenerationError:
    refused += 1
try:
    ckpt.gc_checkpoints(root, keep=0, fence=member)
except cluster.StaleGenerationError:
    refused += 1
fences = [e["action"] for e in events if e["kind"] == "cluster_fence"]
print(refused, fences, ckpt.committed_steps(root), flush=True)
sys.exit(88 if refused == 2 else 1)
"""


def test_zombie_resume_site_is_fenced(tmp_path):
    """The ``zombie_resume`` chaos site against a real membership: the
    child SIGSTOPs itself after committing step 1; the cluster moves to
    generation 1 while it is stopped; once continued, its save and its
    retention delete are both refused, each with a ``cluster_fence``
    event, and step 1 stays the only checkpoint."""
    import signal
    import subprocess
    root, d = str(tmp_path / "ck"), str(tmp_path / "c")
    proc = subprocess.Popen([sys.executable, "-c", _ZOMBIE_CHILD, root, d],
                            cwd=_REPO_ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        _, status = os.waitpid(proc.pid, os.WUNTRACED)
        assert os.WIFSTOPPED(status), status
        _member(d, 0).bump("relaunch")
        os.kill(proc.pid, signal.SIGCONT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 88, err[-3000:]
    assert out.strip() == "2 ['refused_write', 'refused_delete'] [1]"

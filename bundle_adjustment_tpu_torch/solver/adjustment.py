"""Bundle adjustment estimation engine (port of
`bundle_adjustment_tpu/solver/adjustment.py`).

Re-implementation of the reference solver (`BundleAdjustment.java`, survey
rows F1-F15) on the array-based problem representation:

* Gauss-Newton / Levenberg-Marquardt loop with the reference's exact
  bookkeeping: multiplicative diagonal damping, alpha = min(0.25 *
  lambda^-0.05, 0.75) step scaling, 0.2x / 5x lambda schedule with gain test
  on Omega, step rejection, damping auto-shutoff, sqrt(eps) convergence on the
  preconditioned step (estimateModel/updateModel, :203-462);
* Jacobi preconditioning V = diag(N)^(-1/2) (NormalEquationSystem.java:75-91);
* free-network datum via bordered inner-constraint rows, solved as a
  symmetric indefinite system (the LAPACK dspsv path of
  MathExtension.java:338-366 becomes an LU solve: identical solution);
* MatrixInversion modes NONE / FULL / REDUCED / PRE_ELIMINATION with the
  batched EO Schur complement (ops/schur.py);
* centroid centering of all free coordinates (centroidCoordinates, :115-201);
* a-priori / a-posteriori variance of unit weight (:1090-1101, F11).

The per-iteration compute (assembly -> precondition -> reduce -> solve ->
back-substitute -> de-precondition) runs eagerly on the solver's device in
float64; N, n, V and the state stay there, and only max|dx|, Omega and the
factorisations' status are read back each iteration.  The LM control flow
stays in Python, mirroring the reference state machine and firing the same
estimation-state events.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..constants import DEFAULT_MAX_ITERATIONS, SQRT_EPS
from ..models.layout import assign_columns
from ..models.problem import BundleProblem, CompiledScene, ParamState, compile_problem
from ..models.scene import Camera, DirectlyObservedParameterGroup, ScaleBar
from ..ops import linalg
from ..ops.assembly import make_assembler, make_image_block_fn, make_omega_fn
from ..ops.schur import assemble_full_dx, reduce_eo


class MatrixInversion(enum.Enum):
    NONE = "none"
    FULL = "full"
    PRE_ELIMINATION = "pre_elimination"
    REDUCED = "reduced"


class EstimationType(enum.Enum):
    L2NORM = "l2norm"
    SIMULATION = "simulation"


class EstimationState(enum.IntEnum):
    """Mirrors EstimationStateType ids (EstimationStateType.java:24-60)."""

    ERROR_FREE_ESTIMATION = 1
    BUSY = 0
    ITERATE = -1
    CONVERGENCE = -2
    LEVENBERG_MARQUARDT_STEP = -3
    INVERT_NORMAL_EQUATION_MATRIX = -4
    ESTIMATE_STOCHASTIC_PARAMETERS = -5
    INTERRUPT = -6
    SINGULAR_MATRIX = -7
    NO_CONVERGENCE = -8
    OUT_OF_MEMORY = -9
    EXPORT_ADJUSTMENT_RESULTS = -10
    EXPORT_ADJUSTMENT_RESULTS_FAILED = -11


@dataclass
class _Kernels:
    assemble: Callable
    omega: Callable
    solve_intermediate: Callable
    solve_final: Callable


def lm_gain_update(adapted_damping: float, omega_prev: float,
                   omega_cur: float):
    """The reference's gain-ratio damping schedule, shared by the dense and
    the scale (parallel/solver.py) LM drivers.

    prevOmega >= curOmega accepts the step and relaxes lambda x0.2;
    otherwise lambda grows x5 up to the runaway cap 1/sqrt(eps), at which
    point Omega is reset to 0 so the *next* gain test necessarily accepts:
    the escape hatch that forces a step instead of diverging lambda
    (BundleAdjustment.java:403-415).

    Returns (new_damping, new_omega, accepted)."""
    prev = omega_prev if omega_prev > 0 else float(np.finfo(float).max)
    if prev >= omega_cur:
        return adapted_damping * 0.2, omega_cur, True
    adapted_damping *= 5.0
    omega = omega_cur
    if adapted_damping > 1.0 / SQRT_EPS:
        adapted_damping = 1.0 / SQRT_EPS
        omega = 0.0
    return adapted_damping, omega, False


def resolve_device(device) -> torch.device:
    """The solver's device: CUDA unless the caller asks for another.  A CUDA
    device without a card raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU")
    return dev


def _is_out_of_memory(exc: BaseException) -> bool:
    return isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)) \
        or "out of memory" in str(exc) \
        or "can't allocate memory" in str(exc)


class BundleAdjustment:
    """User-facing solver, API-compatible with the reference class
    (BundleAdjustment.java:652-665, 1123-1199).

    ``device``: where the estimation runs; CUDA by default, and raising
    when no card is present unless the caller passes ``device="cpu"``.
    The state (`self.state`), the cofactor matrix (`get_cofactor_matrix`)
    and the residuals are float64 tensors on that device."""

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.cameras: list[Camera] = []
        self.scale_bars: list[ScaleBar] = []
        self.direct_groups: list[DirectlyObservedParameterGroup] = []
        self.estimation_type = EstimationType.L2NORM
        self.invert_normal_equation = MatrixInversion.FULL
        self.max_iterations = DEFAULT_MAX_ITERATIONS
        self.damping_value = 0.0
        self.use_centroided_coordinates = True
        self.apply_aposteriori_variance = True
        self.result_writer = None
        self._listeners: list[Callable[[str, object, object], None]] = []
        self._interrupt = False
        # checkpoint/resume (new capability; survey section 5)
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_every: int = 0
        self._resume_from: Optional[str] = None

        self.compiled: Optional[CompiledScene] = None
        self.state: Optional[ParamState] = None
        self.Qxx: Optional[torch.Tensor] = None
        self.omega: float = 0.0
        self.max_abs_dx: float = 0.0
        self.iteration_step: int = 0
        self.status = EstimationState.BUSY
        self.dtype = torch.float64

    # ------------------------------------------------------------------ API
    def add(self, *items) -> None:
        for item in items:
            if isinstance(item, Camera):
                self.cameras.append(item)
            elif isinstance(item, ScaleBar):
                self.scale_bars.append(item)
            elif isinstance(item, DirectlyObservedParameterGroup):
                self.direct_groups.append(item)
            else:
                raise TypeError(f"cannot add {type(item)!r}")

    def set_estimation_type(self, t: EstimationType) -> None:
        if t not in (EstimationType.L2NORM, EstimationType.SIMULATION):
            raise ValueError(f"unsupported estimation type {t!r}")
        self.estimation_type = t

    def set_invert_normal_equation(self, inv: MatrixInversion) -> None:
        self.invert_normal_equation = inv

    def set_levenberg_marquardt_damping_value(self, lam: float) -> None:
        self.damping_value = abs(lam)

    def set_maximal_number_of_iterations(self, n: int) -> None:
        self.max_iterations = int(n)

    def add_property_change_listener(self, fn) -> None:
        self._listeners.append(fn)

    def interrupt(self) -> None:
        self._interrupt = True

    def set_adjustment_result_writer(self, writer) -> None:
        self.result_writer = writer

    def set_checkpointing(self, path: str, every_n_iterations: int = 10) -> None:
        """Write an LM-state checkpoint every N iterations (atomic .npz)."""
        self.checkpoint_path = path
        self.checkpoint_every = int(every_n_iterations)

    def resume_from(self, path: str) -> None:
        """Resume the next estimate_model() from a saved checkpoint (the
        scene must be identical to the one that produced it)."""
        self._resume_from = path

    def _fire(self, name: str, old, new) -> None:
        for fn in self._listeners:
            fn(name, old, new)

    # ------------------------------------------------------------- numbers
    @property
    def problem(self) -> BundleProblem:
        return self.compiled.problem

    def get_number_of_observations(self) -> int:
        return self.problem.num_observation_rows

    def get_number_of_unknown_parameters(self) -> int:
        return self.problem.num_unknowns

    def get_number_of_datum_conditions(self) -> int:
        return self.problem.defect

    def get_degree_of_freedom(self) -> int:
        return self.problem.dof

    def get_variance_factor_apriori(self) -> float:
        return self.problem.sigma2_apriori

    def get_variance_factor_aposteriori(self) -> float:
        dof = self.get_degree_of_freedom()
        if (dof > 0 and self.omega > 0
                and self.estimation_type != EstimationType.SIMULATION
                and self.apply_aposteriori_variance):
            return abs(self.omega / dof)
        return self.problem.sigma2_apriori

    def get_cofactor_matrix(self) -> Optional[torch.Tensor]:
        if self.invert_normal_equation == MatrixInversion.NONE:
            return None
        return self.Qxx

    def get_object_coordinates(self):
        return self.compiled.object_coordinates

    def get_image_residuals(self) -> torch.Tensor:
        """Post-fit image-coordinate residuals v = observed - predicted
        [N, 2] at the estimated parameters (diagnostic; the reference only
        exposes Omega, survey F9)."""
        blocks_fn = make_image_block_fn(self.problem, self.device, self.dtype)
        _, w, _ = blocks_fn(self.state)
        return w

    # ------------------------------------------------------------- kernels
    def _build_kernels(self) -> _Kernels:
        p = self.problem
        T = p.total_size
        nR = p.reduced_size
        dev, dt = self.device, self.dtype
        col_eo = torch.as_tensor(np.asarray(p.col_eo, np.int64), device=dev)
        assemble = make_assembler(p, dev, dt)
        omega = make_omega_fn(p, dev, dt)
        simulation = self.estimation_type == EstimationType.SIMULATION
        mode = self.invert_normal_equation

        def precondition(N, n, V):
            return V[:, None] * N * V[None, :], V * n

        def system(state: ParamState, damping):
            N, n, V = assemble(state, damping)
            if simulation:
                n = torch.zeros_like(n)
            return (*precondition(N, n, V), V)

        def solve_intermediate(state: ParamState, damping):
            Np, npre, V = system(state, damping)
            if mode == MatrixInversion.PRE_ELIMINATION:
                f = reduce_eo(Np, npre, col_eo, nR)
                dx1 = linalg.solve_symmetric(f.S, f.nr)
                linalg.check_factorisation(f.info)
                dx = assemble_full_dx(f, dx1, T)
            else:
                dx = linalg.solve_symmetric(Np, npre)
            return V * dx

        def solve_final(state: ParamState, damping):
            Np, npre, V = system(state, damping)
            if mode in (MatrixInversion.REDUCED, MatrixInversion.PRE_ELIMINATION):
                f = reduce_eo(Np, npre, col_eo, nR)
                Q1 = linalg.inv_symmetric(f.S)
                linalg.check_factorisation(f.info)
                dx = assemble_full_dx(f, Q1 @ f.nr, T)
                Q = torch.zeros((T, T), dtype=dt, device=dev)
                Q[:nR, :nR] = Q1
            elif mode == MatrixInversion.FULL:
                Q = linalg.inv_symmetric(Np)
                dx = Q @ npre
            else:  # NONE
                dx = linalg.solve_symmetric(Np, npre)
                Q = torch.zeros((T, T), dtype=dt, device=dev)
            return V * dx, V[:, None] * Q * V[None, :]

        return _Kernels(assemble=assemble, omega=omega,
                        solve_intermediate=solve_intermediate,
                        solve_final=solve_final)

    # ------------------------------------------------------- centroid pass
    def _centroid(self, state: ParamState, invert: bool,
                  centroid) -> tuple[ParamState, torch.Tensor]:
        """centroidCoordinates (BundleAdjustment.java:115-201): shift all
        *free* object/camera coordinates (and directly observed coordinate
        values) by -/+ centroid of the free coordinates."""
        p = self.problem
        fp = torch.as_tensor(p.free_points, device=self.device)  # [P, 3]
        fe = torch.as_tensor(p.free_eo_pos, device=self.device)  # [M, 3]
        zero = torch.zeros((), dtype=self.dtype, device=self.device)

        if not invert:
            cnts = p.free_points.sum(axis=0) + p.free_eo_pos.sum(axis=0)
            if not (cnts[0] == cnts[1] == cnts[2] and cnts[0] > 0):
                raise ValueError(
                    f"unequal numbers of free coordinate components {cnts}")
            sums = torch.where(fp, state.points, zero).sum(dim=0) \
                + torch.where(fe, state.eo[:, :3], zero).sum(dim=0)
            centroid = sums / torch.as_tensor(cnts, dtype=self.dtype,
                                              device=self.device)
        centroid = torch.as_tensor(centroid, dtype=self.dtype,
                                   device=self.device)

        shift = centroid if invert else -centroid
        pts = state.points + torch.where(fp, shift[None, :], zero)
        eo = torch.cat([state.eo[:, :3] + torch.where(fe, shift[None, :], zero),
                        state.eo[:, 3:]], dim=1)

        # directly observed coordinate values shift too (:185-200)
        if p.direct_groups:
            sh = shift.cpu().numpy()
            axis = {"OBJ_X": 0, "CAM_X": 0, "OBJ_Y": 1, "CAM_Y": 1,
                    "OBJ_Z": 2, "CAM_Z": 2}
            for dg, group in zip(p.direct_groups, self.direct_groups):
                for i, obs in enumerate(group.observations):
                    if obs.param_type in axis:
                        dg.values[i] += sh[axis[obs.param_type]]

        return state._replace(points=pts, eo=eo), centroid

    # ------------------------------------------------------------ updating
    def _apply_dx(self, state: ParamState, dx) -> tuple[ParamState, float]:
        """x <- x + dx via the column maps; returns max|dx| over assigned
        columns (updateUnknownParameters, BundleAdjustment.java:444-462)."""
        if getattr(self, "_update_maps", (None,))[0] is not self.compiled:
            p = self.problem
            T = p.total_size
            blocks = (p.col_points, p.col_io, p.col_dist, p.col_eo)
            cols = [torch.as_tensor(np.where(c >= 0, c, T).astype(np.int64),
                                    device=self.device) for c in blocks]
            assigned = np.zeros(T, bool)
            for c in blocks:
                assigned[c[c >= 0]] = True
            sel = torch.as_tensor(np.flatnonzero(assigned), device=self.device)
            self._update_maps = (self.compiled, cols, sel)
        _, cols, sel = self._update_maps
        dxp = torch.cat([dx, dx.new_zeros(1)])
        new = ParamState(*(a + dxp[c] for a, c in zip(state, cols)))
        if sel.numel() == 0:
            return new, 0.0
        return new, float(dx[sel].abs().max())

    # ----------------------------------------------------------- main loop
    def estimate_model(self) -> EstimationState:
        self.status = EstimationState.BUSY
        self._fire(self.status.name, False, True)

        derive_first_damping = self.damping_value > 0
        adapted_damping = 0.0
        self.max_abs_dx = 0.0
        last_valid_max_abs_dx = 0.0
        self.omega = 0.0

        # prepare: layout + compile (host), then the state on the device
        layout = assign_columns(self.cameras, self.scale_bars, self.direct_groups)
        self.compiled = compile_problem(self.cameras, self.scale_bars,
                                        self.direct_groups, layout)

        def on_device(st):
            return ParamState(*(torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                                device=self.device)
                                for a in st))

        state = on_device(self.compiled.state)

        centroid = None
        resume = None
        if self._resume_from:
            from .checkpoint import LMCheckpoint

            resume = LMCheckpoint.load(self._resume_from)
            self._resume_from = None

        if resume is not None:
            state = on_device(resume.state)
            centroid = resume.centroid
        elif self.use_centroided_coordinates:
            state, centroid = self._centroid(state, False, None)

        kernels = self._build_kernels()

        runs = self.max_iterations - 1
        is_estimated = False
        estimate_complete = False
        converged = True
        if self.max_iterations == 0:
            estimate_complete = is_estimated = True

        if resume is not None:
            runs = max(1, self.max_iterations - 1 - resume.iteration)
            adapted_damping = resume.adapted_damping
            self.omega = resume.omega
            last_valid_max_abs_dx = resume.max_abs_dx

        Qxx = None
        while not estimate_complete:
            self.max_abs_dx = 0.0
            self.iteration_step = self.max_iterations - runs
            self.status = EstimationState.ITERATE
            self._fire(self.status.name, self.max_iterations, self.iteration_step)

            if derive_first_damping:
                adapted_damping = self.damping_value
                derive_first_damping = False

            estimate_complete = is_estimated
            try:
                if estimate_complete:
                    if self.invert_normal_equation != MatrixInversion.NONE:
                        self.status = EstimationState.INVERT_NORMAL_EQUATION_MATRIX
                        self._fire(self.status.name, False, True)
                    dx, Qxx = kernels.solve_final(state, adapted_damping)
                    if self.invert_normal_equation != MatrixInversion.NONE:
                        self.status = EstimationState.ESTIMATE_STOCHASTIC_PARAMETERS
                        self._fire(self.status.name, False, True)
                else:
                    dx = kernels.solve_intermediate(state, adapted_damping)
            except torch.linalg.LinAlgError:
                # a zero pivot of an LU factorisation (a singular matrix that
                # is not exactly singular shows as non-finite max|dx| below;
                # EstimationStateType.java:36-42)
                self.status = EstimationState.SINGULAR_MATRIX
                self._fire(self.status.name, False, True)
                return self.status
            except Exception as exc:  # map OOM, re-raise bugs
                if _is_out_of_memory(exc):
                    self.status = EstimationState.OUT_OF_MEMORY
                    self._fire(self.status.name, False, True)
                    return self.status
                raise

            # ---- updateModel (:389-442)
            rejected = False
            if adapted_damping > 0:
                alpha = min(0.25 * adapted_damping ** -0.05, 0.75)
                dx = dx * alpha
                cur_omega = float(kernels.omega(state, dx))
                last_damping = adapted_damping
                adapted_damping, self.omega, lma_converge = lm_gain_update(
                    adapted_damping, self.omega, cur_omega)
                self.status = EstimationState.LEVENBERG_MARQUARDT_STEP
                self._fire(self.status.name, last_damping, adapted_damping)
                if not lma_converge:
                    self.max_abs_dx = last_valid_max_abs_dx
                    rejected = True

            if not rejected:
                if estimate_complete:
                    self.omega = (0.0 if self.estimation_type == EstimationType.SIMULATION
                                  else float(kernels.omega(state, dx)))
                state, self.max_abs_dx = self._apply_dx(state, dx)
                last_valid_max_abs_dx = self.max_abs_dx

            if self._interrupt:
                self.status = EstimationState.INTERRUPT
                self._fire(self.status.name, False, True)
                self._interrupt = False
                return self.status

            if not np.isfinite(self.max_abs_dx):
                self.status = EstimationState.SINGULAR_MATRIX
                self._fire(self.status.name, False, True)
                return self.status
            elif self.max_abs_dx <= SQRT_EPS and runs > 0 and adapted_damping == 0:
                is_estimated = True
                self.status = EstimationState.CONVERGENCE
                self._fire(self.status.name, SQRT_EPS, self.max_abs_dx)
            elif runs <= 1:
                if estimate_complete:
                    self.status = EstimationState.NO_CONVERGENCE
                    self._fire(self.status.name, SQRT_EPS, self.max_abs_dx)
                    converged = False
                is_estimated = True
                runs -= 1
            else:
                runs -= 1
                self.status = EstimationState.CONVERGENCE
                self._fire(self.status.name, SQRT_EPS, self.max_abs_dx)

            if (is_estimated or adapted_damping <= SQRT_EPS
                    or runs < self.max_iterations * 0.5 + 1):
                adapted_damping = 0.0

            if (self.checkpoint_path and self.checkpoint_every > 0
                    and self.iteration_step % self.checkpoint_every == 0):
                from .checkpoint import LMCheckpoint

                LMCheckpoint(
                    state=state, iteration=self.iteration_step,
                    adapted_damping=adapted_damping, omega=self.omega,
                    max_abs_dx=self.max_abs_dx, centroid=centroid,
                ).save(self.checkpoint_path)

        if self.use_centroided_coordinates:
            state, _ = self._centroid(state, True, centroid)

        self.state = state
        self.Qxx = Qxx
        self.compiled.write_back(state)

        if self.result_writer is not None:
            try:
                self.status = EstimationState.EXPORT_ADJUSTMENT_RESULTS
                self._fire(self.status.name, None, str(self.result_writer))
                self.result_writer.export(self)
            except Exception:
                self.status = EstimationState.EXPORT_ADJUSTMENT_RESULTS_FAILED
                self._fire(self.status.name, False, True)
                return self.status

        if not converged:
            self.status = EstimationState.NO_CONVERGENCE
            self._fire(self.status.name, SQRT_EPS, self.max_abs_dx)
        else:
            self.status = EstimationState.ERROR_FREE_ESTIMATION
            self._fire(self.status.name, SQRT_EPS, self.max_abs_dx)
        return self.status
